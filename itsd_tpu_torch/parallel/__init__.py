from .mesh import (RowDraws, all_reduce_sum_, data_group, draw, gather_rows,
                   is_main, local_rows, maybe_initialize_distributed,
                   on_local_rows, rank, replicate, row_windows,
                   sharded_rows, under_row_windows, world_size)

__all__ = ["RowDraws", "all_reduce_sum_", "data_group", "draw",
           "gather_rows", "is_main", "local_rows",
           "maybe_initialize_distributed", "on_local_rows", "rank",
           "replicate", "row_windows", "sharded_rows", "under_row_windows",
           "world_size"]
