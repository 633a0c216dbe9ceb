"""Command line of the port.

Usage:
    python -m itsd_tpu_torch.cli.main {train|eval|search} [--config c.yaml]
        [--device cuda] [key=value ...]

Overrides take dotted keys (``diffusion.T=50``) and the reference's flat keys
(``T=50``, ``channel_mult=[1,2]``), as the JAX package's CLI. The other
subcommands of that CLI, and the options of ``train``, ``eval`` and
``search`` that are not yet ported, exit with status 2 and say so.
"""

from __future__ import annotations

import argparse
import sys

from ..utils import load_config, to_dict

COMMANDS = ["train", "eval", "search", "finetune-t", "inference-metrics"]
PORTED = ("train", "eval", "search")


def _parse(argv):
    p = argparse.ArgumentParser(prog="itsd_tpu_torch")
    p.add_argument("command", choices=COMMANDS)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("overrides", nargs="*", help="key=value overrides")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.command not in PORTED:
        print(f"[itsd_tpu_torch] {args.command}: not yet ported",
              file=sys.stderr)
        return 2
    cfg = load_config(args.config, args.overrides)
    print(f"[itsd_tpu_torch] {args.command} on {args.device} with config:")
    print(to_dict(cfg))

    from . import runner
    try:
        if args.command == "train":
            out = runner.train(cfg, device=args.device)
            print(f"final loss: {out['final_loss']} after {out['steps']} "
                  f"steps; checkpoints: {out['checkpoints']}")
        elif args.command == "eval":
            out = runner.evaluate(cfg, device=args.device)
            print(f"sampled grid: {out['path']}")
        else:
            out = runner.run_search(cfg, device=args.device)
            print(f"best score: {out['best_score']} (NFE={out['nfes']})")
    except NotImplementedError as e:
        print(f"[itsd_tpu_torch] {args.command}: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
