from .mesh import (RowDraws, SeqMesh, all_reduce_sum_, data_group,
                   default_seq_mesh, draw, gather_rows, get_seq_mesh,
                   is_main, local_rows, make_seq_mesh,
                   maybe_initialize_distributed, on_local_rows, rank,
                   replicate, row_window, row_windows, seq_mesh_scope,
                   set_seq_mesh, sharded_rows, under_row_windows, world_size)

__all__ = ["RowDraws", "SeqMesh", "all_reduce_sum_", "data_group",
           "default_seq_mesh", "draw", "gather_rows", "get_seq_mesh",
           "is_main", "local_rows", "make_seq_mesh",
           "maybe_initialize_distributed", "on_local_rows", "rank",
           "replicate", "row_window", "row_windows", "seq_mesh_scope",
           "set_seq_mesh", "sharded_rows", "under_row_windows",
           "world_size"]
