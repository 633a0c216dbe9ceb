"""One rank of the port's multi-rank tests: the data axis
(tests/test_torch_parallel.py, suite "data"), ring attention
(tests/test_torch_ring_attention.py, "ring") and spatial sharding
(tests/test_torch_spatial.py, "spatial"; tests/test_torch_spatial_data.py,
"spatial_data", four ranks).

    python tests/_torch_dist_worker.py PORT RANK WORLD DIR [SUITE]

Starts a gloo process group on ``tcp://localhost:PORT`` through
``parallel.maybe_initialize_distributed``, reads ``DIR/inputs.pt`` (written
by the test), runs every case of the suite (default "data") on the CPU and
writes what it computed to ``DIR/rank{RANK}.pt``. Imports the port only.
Any failure raises, so the process exits non-zero and the test shows its
output. ``run_ranks`` is the tests' side: one spawn of the ranks a test
module.
"""

import contextlib
import os
import socket
import subprocess
import sys
import traceback
import warnings
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from itsd_tpu_torch import core as PC  # noqa: E402
from itsd_tpu_torch import parallel  # noqa: E402
from itsd_tpu_torch.cli import runner  # noqa: E402
from itsd_tpu_torch.kernels import attention as attn_kernels  # noqa: E402
from itsd_tpu_torch.kernels import groupnorm as gn_kernels  # noqa: E402
from itsd_tpu_torch.kernels import ring_attention as ring  # noqa: E402
from itsd_tpu_torch.models import (UNet, ViT, ViTConfig,  # noqa: E402
                                   cond_unet_config)
from itsd_tpu_torch.models import uncond_unet_config  # noqa: E402
from itsd_tpu_torch.models import unet as unet_module  # noqa: E402
from itsd_tpu_torch.parallel import spatial  # noqa: E402
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
    if kind == "vit":
        return ViT(ViTConfig(**kw))
    return UNet((cond_unet_config if kind == "cond" else
                 uncond_unet_config)(**kw))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(out_dir, suite, timeout, meanwhile=None, world=2):
    """Start ``world`` workers of ``suite`` on ``out_dir/inputs.pt``, run
    ``meanwhile()`` (JAX's references compile while the workers run), wait
    for each under ``timeout`` seconds (killed past it) and return
    (``meanwhile``'s result, each rank's results, each rank's log).
    Asserts that every rank exited 0."""
    port = free_port()
    env = dict(os.environ)
    for v in ("ITSD_MULTIHOST", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(v, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r),
         str(world), str(out_dir), suite],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env) for r in range(world)]
    logs, extra = [], None
    try:
        extra = meanwhile() if meanwhile is not None else None
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed: time limit]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed ({p.returncode}):\n{log}"
    got = [torch.load(os.path.join(str(out_dir), f"rank{r}.pt"),
                      weights_only=False) for r in range(world)]
    return extra, got, logs


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


def train_steps(case, mesh, rows):
    """A train step case of ``inputs["train"]``: its params (or a seeded
    init), its batches (``rows`` picks this rank's), its step options, its
    injected draws (t, noise, label-dropout mask and the UNet's dropout
    masks) or a seeded generator; with ``mesh`` (None: one process), the
    step over the layout (the NCHW masks cut to the rank's block too)."""
    model = build_unet(case["model"])
    if case["params"] is not None:
        model.load_state_dict(case["params"])
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(
        OptimizerConfig(**case["opt"]), model.parameters()))
    step = make_train_step(PC.linear_schedule(1e-4, 0.02, case["T"],
                                              device="cpu"),
                           mesh=mesh, **case["step"])
    mask_rows = rows if mesh is None else (
        lambda a: spatial.image_rows(a, mesh, 2))
    gen = (torch.Generator().manual_seed(case["seed"])
           if case["seed"] is not None else None)
    metrics = []
    for i, batch in enumerate(case["batches"]):
        draws = case["draws"][i] if case["draws"] else (None, None, None)
        masks = (injected_dropout(case["masks"][i], mask_rows)
                 if case["masks"]
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


def data_suite(inp, out_dir, rank, started):
    """The data axis: the mesh helpers, train steps, searches, Picard and
    the runner under the process group."""
    result = {}
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

    dp = parallel.make_seq_mesh(1)
    result["train"] = {name: train_steps(case, dp, rows)
                       for name, case in inp["train"].items()}
    # "ring" from the environment, as a launcher may set it: the step's
    # layout (seq groups of one) keeps each rank's attention local
    with mock.patch.dict(os.environ, {"ITSD_ATTN_IMPL": "ring"}):
        result["train_ring_env"] = train_steps(inp["train"]["jax_uncond"],
                                               dp, rows)
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
    dirs = rank_dirs(out_dir, rank)
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
    return result


def rank_dirs(out_dir, rank):
    """The runner's output directories of a rank, so that the test sees
    which rank wrote."""
    return [f"save_weight_dir={out_dir}/r{rank}/ckpt",
            f"metrics_save_dir={out_dir}/r{rank}/metrics",
            f"sampled_dir={out_dir}/r{rank}/sampled"]


# ---------------------------------------------------------------------------
# the seq axis: ring attention


def attention_grads(fn, case):
    """fn(q, k, v) and the gradients of sum((fn - tgt)^2) in q, k, v."""
    qkv = [case[n].clone().requires_grad_() for n in "qkv"]
    out = fn(*qkv)
    ((out - case["tgt"]) ** 2).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in qkv]}


def model_grads(case, impl):
    """A model of ``case`` with ``attention_impl=impl`` on its weights: the
    output on its inputs and the gradients of its parameters of
    sum(out * cot)."""
    kind, kw = case["model"]
    model = build_unet((kind, dict(kw, attention_impl=impl)))
    model.load_state_dict(case["params"])
    out = model(case["x"], case["t"])
    (out * case["cot"]).sum().backward()
    return {"out": out.detach(),
            "grads": {k: p.grad for k, p in model.named_parameters()}}


def ring_suite(inp, out_dir, rank, started):
    """Ring attention at two ranks: the global view (every rank holds the
    whole q, k, v), the per-rank body on each rank's tokens, bf16,
    tokens that do not tile, the row-shard route of "auto", and the UNet
    and the ViT with attention_impl="ring"."""
    r = inp["ring"]
    mesh = parallel.default_seq_mesh()
    result = {"mesh": (mesh.data, mesh.seq, mesh.seq_rank),
              "registered": parallel.get_seq_mesh()}
    result["global"] = [attention_grads(
        lambda q, k, v: ring.sequence_sharded_attention(q, k, v, mesh), c)
        for c in r["cases"]]
    result["impl_ring"] = [attention_grads(
        lambda q, k, v: attn_kernels.spatial_attention(q, k, v, "ring"), c)
        for c in r["cases"]]
    result["registry_default_kept"] = parallel.get_seq_mesh() is None

    def body(case):
        local = {n: spatial.cut_seq(case[n], 1, mesh) for n in
                 ("q", "k", "v", "tgt")}
        return attention_grads(
            lambda q, k, v: ring.ring_attention(q, k, v, mesh), local)

    result["body"] = [body(c) for c in r["cases"]]
    local = {n: spatial.cut_seq(r["cases"][0][n], 1, mesh)
             for n in ("q", "k", "v", "tgt")}
    with spatial.row_shards(mesh):
        result["auto_rows"] = [attention_grads(
            lambda q, k, v, impl=impl: attn_kernels.spatial_attention(
                q, k, v, impl), local) for impl in ("auto", "flash", "xla")]
    b = r["bf16"]
    result["bf16"] = ring.sequence_sharded_attention(
        *(b[n].to(torch.bfloat16) for n in "qkv"), mesh)
    odd = r["odd"]
    try:
        ring.sequence_sharded_attention(odd["q"], odd["k"], odd["v"], mesh)
    except ValueError as e:
        result["odd_raise"] = str(e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result["odd_out"] = attn_kernels.spatial_attention(
            odd["q"], odd["k"], odd["v"], "ring")
    result["odd_warn"] = [str(w.message) for w in caught]
    result["models"] = {name: model_grads(case, "ring")
                        for name, case in r["models"].items()}
    result["window"] = window_ring(r["cases"][0])
    return result


def window_ring(case):
    """impl="ring" with nothing registered on each rank's window of the
    batch rows (``on_local_rows``, as the searches split candidates): the
    gathered output and the gradients of q, k and v summed over the
    ranks (each rank's covers its rows)."""
    c = case["q"].shape[-1]
    x = torch.cat([case[n] for n in "qkv"], -1).requires_grad_()
    out = parallel.on_local_rows(
        lambda rows: attn_kernels.spatial_attention(*rows.split(c, -1),
                                                    "ring"),
        x, parallel.data_group())
    ((out - case["tgt"]) ** 2).sum().backward()
    grad = x.grad.clone()
    parallel.all_reduce_sum_([grad])
    return {"out": out.detach(), "grads": list(grad.split(c, -1))}


# ---------------------------------------------------------------------------
# the seq axis: spatial sharding


def conv_module(spec):
    """One of the UNet's convolutions: ("conv3", C), ("down", C, kind),
    ("up", C, kind)."""
    kind, C = spec[:2]
    if kind == "conv3":
        return unet_module.Conv(C, C, 3, padding=1)
    if kind == "down":
        return unet_module.DownSample(C, spec[2])
    return unet_module.UpSample(C, spec[2])


def sharded_grads(fn, params, x, cot, mesh, h_axis):
    """fn on this rank's rows of ``x`` under ``row_shards``: the gathered
    output, the gathered gradient of x and the parameters' gradients
    summed over the seq ranks, of sum(out * cot)."""
    xl = spatial.image_rows(x, mesh, h_axis).requires_grad_()
    with spatial.row_shards(mesh):
        y = fn(xl)
        (y * spatial.image_rows(cot, mesh, h_axis)).sum().backward()
    return {"out": spatial.gather_image(y.detach(), mesh, h_axis),
            "dx": spatial.gather_image(xl.grad, mesh, h_axis),
            "dparams": {k: spatial.all_reduce_sum(p.grad, mesh.seq_group)
                        for k, p in params}}


def pixel_means(unit):
    """A feature extractor for the tracked path's tests: each image's mean
    colour."""
    return unit.float().mean(dim=(1, 2))


def spatial_runner(overrides, params, real_features, dirs, samplers=None):
    """The runner with train.spatial_shard=2: evaluate (and with each of
    ``samplers``), sample_with_metrics and 2 steps of train."""
    def cfg(*extra):
        return load_config(None, overrides + dirs + ["train.spatial_shard=2",
                                                     *extra])

    result = {"evaluate": runner.evaluate(cfg(), params=params,
                                          device="cpu")["images"]}
    result["samplers"] = {
        name: runner.evaluate(cfg(*extra), params=params,
                              device="cpu")["images"]
        for name, extra in (samplers or {}).items()}
    tracked = runner.sample_with_metrics(
        cfg(), params, feature_fn=pixel_means, real_features=real_features,
        tag="spatial", device="cpu")
    result["tracked"] = {k: tracked[k] for k in ("images", "history")}
    out = runner.train(cfg(), max_steps=2, device="cpu")
    result["runner_train"] = {"losses": out["losses"],
                              "params": out["state"].model.state_dict()}
    return result


def vit_suite(v, mesh, rank, out_dir):
    """The ViT on two ranks' rows: its forward and gradients, a dropout
    mask cut along the tokens, and the runner."""
    model = build_unet(v["model"])
    model.load_state_dict(v["params"])
    result = {"forward": sharded_grads(
        lambda x: model(x, v["t"]), list(model.named_parameters()),
        v["x"], v["cot"], mesh, 1)}
    tokens = v["dropout_shape"]
    local = (tokens[0], tokens[1] // mesh.seq, tokens[2])
    mask = unet_module.dropout(
        torch.ones(local), 0.5,
        parallel.RowDraws(torch.Generator().manual_seed(4), mesh), h_axis=1)
    result["dropout"] = spatial.gather_image(mask, mesh, 1)
    dirs = [d.replace(f"/r{rank}/", f"/r{rank}/vit_")
            for d in rank_dirs(out_dir, rank)]
    result.update(spatial_runner(v["overrides"], v["runner_params"],
                                 v["real_features"], dirs))
    return result


def spatial_suite(inp, out_dir, rank, started):
    """Image rows over two ranks: each convolution kind's halo, the
    row-shard GroupNorm (its plain version on the CPU), train steps of
    both backbones, the ancestral sampler, the runner's evaluate,
    sample_with_metrics and train with train.spatial_shard=2, and the ViT
    (``vit_suite``)."""
    sp = inp["spatial"]
    mesh = parallel.make_seq_mesh(2)
    result = {"mesh": (mesh.data, mesh.seq, mesh.seq_rank)}
    result["convs"] = {}
    for name, case in sp["convs"].items():
        m = conv_module(case["spec"])
        m.load_state_dict(case["params"])
        result["convs"][name] = sharded_grads(
            m, list(m.named_parameters()), case["x"], case["cot"], mesh, 2)
    g = sp["gn"]
    w, b_ = (g[n].clone().requires_grad_() for n in ("weight", "bias"))
    result["gn"] = sharded_grads(
        lambda x: gn_kernels.groupnorm_swish_rows(
            x, w, b_, g["groups"], mesh, act=g["act"]),
        [("weight", w), ("bias", b_)], g["x"], g["cot"], mesh, 2)

    def rows(a):
        return spatial.image_rows(a, mesh, 1 if a.dim() == 4 else None)

    result["train"] = {name: train_steps(case, mesh, rows)
                       for name, case in sp["train"].items()}

    s = sp["sampler"]
    model = build_unet(s["model"])
    model.load_state_dict(s["params"])
    model.eval()
    sched = PC.linear_schedule(1e-4, 0.02, s["T"], device="cpu")

    def eps_fn(x, t):
        return model(x, t)

    with torch.no_grad():
        local = spatial.on_image_rows(
            lambda x, gen, nf: PC.sample(sched, eps_fn, x, generator=gen),
            s["x_T"], torch.Generator().manual_seed(s["seed"]), None, mesh,
            False)
    result["sampler"] = spatial.gather_image(local, mesh)

    r = sp["runner"]
    result.update(spatial_runner(r["overrides"], r["params"],
                                 r["real_features"], rank_dirs(out_dir, rank),
                                 r["samplers"]))
    result["vit"] = vit_suite(sp["vit"], mesh, rank, out_dir)
    return result


def spatial_data_suite(inp, out_dir, rank, started):
    """Four ranks as data = 2 by seq = 2: the layout's groups, train steps
    (batch rows over the data ranks, image rows over the seq ranks), a
    guided evaluate whose batch splits over the data ranks, runner.train,
    and the ring's global view over a registered layout."""
    sd = inp["spatial_data"]
    mesh = parallel.make_seq_mesh(2)
    result = {"mesh": (mesh.data, mesh.seq, mesh.data_rank, mesh.seq_rank),
              "gathered": spatial.gather_image(spatial.image_rows(
                  sd["image"], mesh), mesh)}
    def rows(a):
        return spatial.image_rows(a, mesh, 1 if a.dim() == 4 else None)

    result["train"] = {name: train_steps(case, mesh, rows)
                       for name, case in sd["train"].items()}
    dirs = rank_dirs(out_dir, rank)
    result["evaluate"] = runner.evaluate(
        load_config(None, sd["cfg_overrides"] + dirs + [
            "train.spatial_shard=2"]), params=sd["cfg_params"],
        device="cpu")["images"]
    out = runner.train(load_config(None, sd["overrides"] + dirs + [
        "train.spatial_shard=2"]), max_steps=2, device="cpu")
    result["runner_train"] = out["losses"]
    q = sd["qkv"]
    with parallel.seq_mesh_scope(mesh):
        result["ring"] = attn_kernels.spatial_attention(q[0], q[1], q[2],
                                                        "ring")
    return result


SUITES = {"data": data_suite, "ring": ring_suite, "spatial": spatial_suite,
          "spatial_data": spatial_data_suite}


def main():
    port, rank, world, out_dir = sys.argv[1:5]
    suite = sys.argv[5] if len(sys.argv) > 5 else "data"
    rank, world = int(rank), int(world)
    started = parallel.maybe_initialize_distributed(
        device="cpu", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank, timeout=120)
    try:
        torch.set_num_threads(1)
        inp = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
        result = SUITES[suite](inp, out_dir, rank, started)
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
