"""Command line of the port.

Usage:
    python -m itsd_tpu_torch.cli.main
        {train|eval|search|finetune-t|inference-metrics}
        [--config c.yaml] [--device cuda] [key=value ...]

Overrides take dotted keys (``diffusion.T=50``) and the reference's flat keys
(``T=50``, ``channel_mult=[1,2]``), as the JAX package's CLI. The options
that are not yet ported (the sequence-sharded ones) exit with status 2 and
say so.

On several GPUs, one process each:

    torchrun --nproc_per_node=N -m itsd_tpu_torch.cli.main train|search ...

starts a process group (``parallel.maybe_initialize_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) before the command runs;
rank 0 prints the config and the summary and writes the files.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch.distributed as dist

from ..parallel import (is_main, maybe_initialize_distributed, rank,
                        world_size)
from ..utils import load_config, to_dict

COMMANDS = ["train", "eval", "search", "finetune-t", "inference-metrics"]


def _parse(argv):
    p = argparse.ArgumentParser(prog="itsd_tpu_torch")
    p.add_argument("command", choices=COMMANDS)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("overrides", nargs="*", help="key=value overrides")
    # intermixed: overrides may follow --config and --device (the plain
    # parser of older Python 3.12 releases rejects them there)
    return p.parse_intermixed_args(argv)


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    t0 = time.perf_counter()
    started = maybe_initialize_distributed(device=args.device)
    try:
        if started:
            print(f"[itsd_tpu_torch] rank {rank()} of world_size "
                  f"{world_size()}, backend {dist.get_backend()}, process "
                  f"group started in {time.perf_counter() - t0:.3f} s",
                  flush=True)
        return _run(args)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args) -> int:
    cfg = load_config(args.config, args.overrides)
    main_rank = is_main()
    if main_rank:
        print(f"[itsd_tpu_torch] {args.command} on {args.device} with "
              "config:")
        print(to_dict(cfg))

    from . import runner
    try:
        if args.command == "train":
            out = runner.train(cfg, device=args.device)
            summary = (f"final loss: {out['final_loss']} after "
                       f"{out['steps']} steps; checkpoints: "
                       f"{out['checkpoints']}")
        elif args.command == "eval":
            out = runner.evaluate(cfg, device=args.device)
            summary = f"sampled grid: {out['path']}"
        elif args.command == "finetune-t":
            out = runner.finetune_extended_T(cfg, device=args.device)
            summary = (f"final loss: {out['final_loss']} "
                       f"(ckpt T detected: {out['ckpt_T_detected']})")
        elif args.command == "inference-metrics":
            out = runner.inference_metrics(cfg, device=args.device)
            summary = (f"tracked {len(out['history'])} metric points; the "
                       f"last (t, FID, IS, CLIP): {out['history'][-1]}")
        else:
            out = runner.run_search(cfg, device=args.device)
            summary = f"best score: {out['best_score']} (NFE={out['nfes']})"
        if main_rank:
            print(summary)
    except NotImplementedError as e:
        print(f"[itsd_tpu_torch] {args.command}: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
