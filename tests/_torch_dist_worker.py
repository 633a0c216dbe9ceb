"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python tests/_torch_dist_worker.py PORT RANK WORLD DIR

Starts a gloo process group on ``tcp://localhost:PORT`` through
``parallel.maybe_initialize_distributed``, reads ``DIR/inputs.pt`` (written
by the test), runs every case below on the CPU and writes what it computed
to ``DIR/rank{RANK}.pt``. Imports the port only. Any failure raises, so the
process exits non-zero and the test shows its output.
"""

import contextlib
import os
import sys
import traceback
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from itsd_tpu_torch import core as PC  # noqa: E402
from itsd_tpu_torch import parallel  # noqa: E402
from itsd_tpu_torch.cli import runner  # noqa: E402
from itsd_tpu_torch.models import UNet, cond_unet_config  # noqa: E402
from itsd_tpu_torch.models import uncond_unet_config  # noqa: E402
from itsd_tpu_torch.models import unet as unet_module  # noqa: E402
from itsd_tpu_torch.search import algorithms as A  # noqa: E402
from itsd_tpu_torch.train import (OptimizerConfig,  # noqa: E402
                                  create_train_state, make_optimizer,
                                  make_train_step)
from itsd_tpu_torch.utils import load_config  # noqa: E402


def analytic_eps(sched, s):
    """The exact eps-predictor for data ~ N(0, s^2 I)."""
    def eps_fn(x, t):
        ab = sched.alphas_bar[t].reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sqrt(1.0 - ab) * x / (ab * s ** 2 + (1.0 - ab))
    return eps_fn


def build_unet(spec):
    kind, kw = spec
    return UNet((cond_unet_config if kind == "cond" else
                 uncond_unet_config)(**kw))


@contextlib.contextmanager
def injected_dropout(masks, rows):
    """The UNet's dropout with the given keep masks (the global batch's,
    NCHW, in call order; ``rows`` picks this rank's) in place of its own
    draws. Each is used once, and every one must be."""
    queue = list(masks)

    def inject(h, rate, generator):
        mask = rows(queue.pop(0))
        assert mask.shape == h.shape, (mask.shape, h.shape)
        return torch.where(mask, h / (1.0 - rate),
                           torch.zeros((), dtype=h.dtype))

    with mock.patch.object(unet_module, "dropout", inject):
        yield
    assert not queue, f"{len(queue)} dropout masks unused"


def train_steps(case, shard, rows):
    """A train step case of ``inputs["train"]``: its params (or a seeded
    init), its batches (``rows`` picks this rank's), its step options, its
    injected draws (t, noise, label-dropout mask and the UNet's dropout
    masks) or a seeded generator."""
    model = build_unet(case["model"])
    if case["params"] is not None:
        model.load_state_dict(case["params"])
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(
        OptimizerConfig(**case["opt"]), model.parameters()))
    step = make_train_step(PC.linear_schedule(1e-4, 0.02, case["T"],
                                              device="cpu"),
                           shard=shard, **case["step"])
    gen = (torch.Generator().manual_seed(case["seed"])
           if case["seed"] is not None else None)
    metrics = []
    for i, batch in enumerate(case["batches"]):
        draws = case["draws"][i] if case["draws"] else (None, None, None)
        masks = (injected_dropout(case["masks"][i], rows) if case["masks"]
                 else contextlib.nullcontext())
        with masks:
            m = step(state, {k: rows(v) for k, v in batch.items()}, gen,
                     *draws)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    # the tensors whose exact gradient is 0: their computed one is f32
    # noise (< 1e-6 here, >= 1e-4 for the others)
    tiny = {k for k, p in model.named_parameters()
            if p.grad.abs().max().item() < 1e-6}
    return {"metrics": metrics, "params": model.state_dict(),
            "ema": dict(state.ema), "tiny_grads": tiny}


def searches(inp, shard):
    """Each algorithm on the analytic harness, draws from a seeded
    generator, split over the ranks by ``shard``."""
    s = inp["search"]
    sched = PC.linear_schedule(1e-4, 0.02, s["T"], device="cpu")
    eps = analytic_eps(sched, 0.5)
    pattern = s["pattern"]

    def verifier(im):
        return -torch.mean((im - pattern) ** 2)

    def denoise(x, g, nf):
        return PC.sample(sched, eps, x, generator=g, noise_fn=nf)

    shape = s["shape"]
    out = {}
    for name in s["algorithms"]:
        g = torch.Generator().manual_seed(7)
        if name == "random":
            r = A.random_search(shape, denoise, verifier, 4, generator=g,
                                shard=shard)
        elif name == "zero_order":
            r = A.zero_order_search(s["pivot"], denoise, verifier,
                                    n_neighbors=4, n_iterations=2,
                                    return_images=True, generator=g,
                                    shard=shard)
        elif name == "path":
            r = A.path_search(sched, eps, verifier, shape, n_paths=4,
                              n_active=2, injection_steps=(12,), delta_f=3,
                              generator=g, shard=shard)
        elif name == "pruned":
            # 8 -> 4 -> 1 candidates of one image: the last survivor's
            # row does not divide over two ranks, so it runs whole on each
            r = A.pruned_search(sched, eps, verifier, s["pruned_shape"],
                                n_candidates=8,
                                prune_schedule=((14, 4), (8, 1)),
                                generator=g, shard=shard)
        elif name == "smc":
            r = A.smc_search(sched, eps, verifier, shape, n_particles=4,
                             resample_steps=(14, 8), lambda_temp=50.0,
                             generator=g, shard=shard)
        else:
            r = A.gradient_search(s["pivot"], sched, eps, verifier,
                                  n_iterations=3, lr=0.05,
                                  return_images=True, generator=g,
                                  shard=shard)
        out[name] = {"best_score": r.best_score,
                     "best_images": r.best_images,
                     "history": {k: v for k, v in r.history.items()
                                 if isinstance(v, (torch.Tensor, list))}}
    # random search on JAX's draws, fed through noise_fn
    r = A.random_search(shape, denoise, verifier, 4,
                        noise_fn=s["jax_draws"], shard=shard)
    out["random_jax_draws"] = {"best_score": r.best_score,
                               "best_images": r.best_images,
                               "scores": r.history["scores"]}
    return out


def run_search(overrides):
    """runner.run_search on seeded weights: its best score and images and
    its score history."""
    cfg = load_config(None, overrides)
    model, _ = runner.build_model(cfg)
    res = runner.run_search(cfg, params=runner.init_params(cfg, model),
                            device="cpu")
    return {"best_score": res["best_score"],
            "best_images": res["result"].best_images,
            "scores": res["result"].history["scores"]}


def cfg_picard(case, shard):
    """Picard on the conditional UNet's guided eps_fn, its grid's rows
    split over the ranks by ``shard``."""
    model = build_unet(case["model"])
    model.init_weights(torch.Generator().manual_seed(3))
    model.eval().requires_grad_(False)
    sched = PC.linear_schedule(1e-4, 0.02, case["T"], device="cpu")
    eps_fn = runner.make_eps_fn(model, True, case["labels"], 1.8)
    with torch.no_grad():
        x, sweeps = PC.parallel_picard_sample(
            sched, eps_fn, case["x_T"], num_steps=case["n"], tol=1e-5,
            max_iters=case["n"], clip_output=False, shard=shard)
    return {"x": x, "sweeps": sweeps}


class Draws:
    """noise_fn of a search: site -> the draw(s) the test recorded."""

    def __init__(self, sites):
        self.sites = sites

    def __call__(self, site, i, t):
        d = self.sites[site]
        return d[i] if isinstance(d, list) else d


def main():
    port, rank, world, out_dir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    result = {}
    started = parallel.maybe_initialize_distributed(
        device="cpu", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank, timeout=120)
    try:
        torch.set_num_threads(1)
        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        inp["search"]["jax_draws"] = Draws(inp["search"]["jax_draws"])
        group = parallel.data_group()
        result["mesh"] = {
            "started": started,
            "again": parallel.maybe_initialize_distributed(device="cpu"),
            "world_size": parallel.world_size(),
            "rank": parallel.rank(), "is_main": parallel.is_main(),
            "gathered": parallel.gather_rows(parallel.local_rows(
                torch.arange(8.0).reshape(4, 2))),
        }
        try:
            parallel.local_rows(torch.zeros(3, 2))
        except ValueError as e:
            result["mesh"]["odd_rows"] = str(e)
        lin = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(lin.weight, float(rank))
        result["mesh"]["replicated"] = parallel.replicate(lin).weight.data

        def rows(a):
            return parallel.local_rows(a, group)

        result["train"] = {name: train_steps(case, group, rows)
                           for name, case in inp["train"].items()}
        result["search"] = searches(inp, group)
        sched = PC.linear_schedule(1e-4, 0.02, inp["picard"]["T"],
                                   device="cpu")
        x, sweeps = PC.parallel_picard_sample(
            sched, analytic_eps(sched, 0.5), inp["picard"]["x_T"],
            num_steps=inp["picard"]["n"], tol=1e-5, clip_output=False,
            shard=group)
        result["picard"] = {"x": x, "sweeps": sweeps}

        # the runner under the process group: each rank writes under its
        # own directories, so the test sees which rank wrote
        base = inp["runner"]["overrides"]
        dirs = [f"save_weight_dir={out_dir}/r{rank}/ckpt",
                f"metrics_save_dir={out_dir}/r{rank}/metrics",
                f"sampled_dir={out_dir}/r{rank}/sampled"]
        out = runner.train(load_config(None, base + dirs), max_steps=2,
                           device="cpu")
        result["runner_train"] = {"losses": out["losses"],
                                  "checkpoints": out["checkpoints"]}
        # the conditional model with representations every batch
        cdirs = [d.replace(f"/r{rank}/", f"/r{rank}/cond_") for d in dirs]
        runner.train(load_config(None, base + cdirs + inp["runner"]["cond"]),
                     max_steps=2, device="cpu")
        try:
            runner.train(load_config(None, base + dirs + [
                "train.batch_size=3"]), max_steps=1, device="cpu")
        except ValueError as e:
            result["runner_train"]["odd_batch"] = str(e)
        result["run_search"] = run_search(inp["runner"]["search"] + dirs)
        # the CFG model, whose rank holds fewer rows than labels
        result["cfg_search"] = {
            name: run_search(inp["runner"]["search"] + dirs + extra)
            for name, extra in inp["runner"]["cfg_search"].items()}
        result["cfg_picard"] = cfg_picard(inp["cfg_picard"], group)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # the other rank may wait in a collective: do not wait
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
