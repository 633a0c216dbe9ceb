"""The port's ring attention (``itsd_tpu_torch/kernels/ring_attention.py``)
at two gloo ranks on the CPU, against one process and against JAX's
``sequence_sharded_attention`` on a 2-device mesh of the virtual CPU
devices (tests/conftest.py); the counterpart of tests/test_ring_attention.py.

Two worker processes (tests/_torch_dist_worker.py, suite "ring") start a
process group and run every case once (the ``ranks`` fixture); the tests
read what they wrote. The CPU runs each hop's plain version, so the ring
differs from one device only by its log-sum-exp merge and the order of its
f32 sums.

Tolerances (float32, as JAX's tests): the forward 1e-5 absolute and
relative; the gradients 1e-4. bf16: 2e-2 (two bf16 roundings of O(1)
outputs, each 2^-8 relative). The models: the forward 1e-5, the
parameters' gradients 1e-4 relative to the model's largest gradient (the
gradient of a bias before a GroupNorm is 0 but for f32 noise).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.kernels.ring_attention import (
    sequence_sharded_attention as jax_sequence_sharded_attention)
from itsd_tpu.parallel import make_mesh
from itsd_tpu_torch import parallel
from itsd_tpu_torch.kernels import attention
from itsd_tpu_torch.kernels import ring_attention as ring
from itsd_tpu_torch.parallel import SeqMesh, spatial

import _torch_dist_worker as worker
from _torch_port import one_torch_thread  # noqa: F401

WORKER_TIMEOUT = 180  # seconds, each worker
CASES = [(2, 64, 8), (2, 96, 16), (1, 32, 4)]  # (B, N, C): N/2 a rank
UNET = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
            dropout=0.0)  # attention at 8x8 = 64 tokens of 16x16 images
VIT = dict(img_size=16, patch_size=2, embed_dim=32, depth=2, num_heads=4,
           dropout=0.0)  # 64 tokens


def _case(rng, b, n, c):
    mk = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, n, c)).astype(np.float32))
    return {"q": mk(), "k": mk(), "v": mk(), "tgt": mk()}


def _model_case(rng, kind, kw):
    """A model's seeded weights (its init, every tensor moved by 0.1 of a
    normal draw so that no branch is near zero), inputs and a cotangent."""
    model = worker.build_unet((kind, dict(kw, attention_impl="xla")))
    model.init_weights(torch.Generator().manual_seed(1))
    params = {k: v + 0.1 * torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in model.state_dict().items()}
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(
        np.float32))
    return {"model": (kind, kw), "params": params, "x": x,
            "t": torch.tensor([3, 7]), "cot": torch.from_numpy(
                rng.standard_normal((2, 16, 16, 3)).astype(np.float32))}


def _jax_refs(cases):
    """JAX's sequence_sharded_attention on a 2-device seq mesh: the output
    and the gradients of sum((out - tgt)^2) of each case."""
    mesh = make_mesh((2,), ("seq",), devices=jax.devices()[:2])
    out = []
    for c in cases:
        q, k, v, tgt = (jnp.asarray(c[n].numpy()) for n in
                        ("q", "k", "v", "tgt"))

        def loss(q, k, v, tgt=tgt):
            return jnp.sum((jax_sequence_sharded_attention(
                q, k, v, mesh, axis="seq") - tgt) ** 2)

        o = jax_sequence_sharded_attention(q, k, v, mesh, axis="seq")
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        out.append({"out": np.asarray(o),
                    "grads": [np.asarray(g) for g in grads]})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(17)
    cases = [_case(rng, *shape) for shape in CASES]
    inputs = {"ring": {
        "cases": cases, "bf16": _case(rng, 2, 64, 32),
        "odd": _case(rng, 1, 13, 4),
        "models": {"unet": _model_case(rng, "uncond", UNET),
                   "vit": _model_case(rng, "vit", VIT)}}}
    torch.save(inputs, out / "inputs.pt")
    jax_out, got, logs = worker.run_ranks(out, "ring", WORKER_TIMEOUT,
                                          lambda: _jax_refs(cases))
    return dict(got=got, inputs=inputs["ring"], jax=jax_out, logs=logs)


def _plain_grads(case):
    return worker.attention_grads(
        lambda q, k, v: attention.attention_plain(
            q, k, v, float(q.shape[-1]) ** -0.5), case)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_forward_matches_single_device_and_jax(ranks, i):
    """The global view at two ranks (every rank the whole output) against
    one device's attention and JAX's ring on a 2-device mesh."""
    case = ranks["inputs"]["cases"][i]
    want = _plain_grads(case)["out"]
    for got in ranks["got"]:
        assert got["mesh"] == (1, 2, got["mesh"][2])
        _close(got["global"][i]["out"], want, 1e-5)
        _close(got["global"][i]["out"], ranks["jax"][i]["out"], 1e-5)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_gradients_match_single_device_and_jax(ranks, i):
    """The gradients of q, k and v through the ring's backward (the dq and
    dk/dv of each hop from the merged lse, dk and dv travelling home) and
    the global view's gather: the whole gradient on every rank."""
    want = _plain_grads(ranks["inputs"]["cases"][i])["grads"]
    for got in ranks["got"]:
        for g, w, j in zip(got["global"][i]["grads"], want,
                           ranks["jax"][i]["grads"]):
            _close(g, w, 1e-4)
            _close(g, j, 1e-4)


def test_ring_body_holds_each_ranks_share(ranks):
    """The per-rank body on each rank's tokens (cut by hand): the two
    ranks' outputs and gradients, put together, are one device's."""
    for i, case in enumerate(ranks["inputs"]["cases"]):
        want = _plain_grads(case)
        out = torch.cat([g["body"][i]["out"] for g in ranks["got"]], dim=1)
        _close(out, want["out"], 1e-5)
        for n in range(3):
            got = torch.cat([g["body"][i]["grads"][n] for g in ranks["got"]],
                            dim=1)
            _close(got, want["grads"][n], 1e-4)


def test_impl_ring_takes_the_default_layout_without_registering(ranks):
    """``spatial_attention(impl="ring")`` with nothing registered splits
    the tokens over every rank (the default layout) and leaves the registry
    empty, as JAX's."""
    for got in ranks["got"]:
        assert got["registered"] is None and got["registry_default_kept"]
        for i, case in enumerate(ranks["inputs"]["cases"]):
            want = _plain_grads(case)
            _close(got["impl_ring"][i]["out"], want["out"], 1e-5)
            for g, w in zip(got["impl_ring"][i]["grads"], want["grads"]):
                _close(g, w, 1e-4)


def test_impl_ring_stays_local_on_a_ranks_window_of_rows(ranks):
    """With nothing registered and each rank on its own rows of the batch
    (``on_local_rows``, as the searches split their candidates), "ring"
    attends within the rank's rows, whose tokens are whole: the gathered
    output and gradients are one process's."""
    want = _plain_grads(ranks["inputs"]["cases"][0])
    for got in ranks["got"]:
        _close(got["window"]["out"], want["out"], 1e-5)
        for g, w in zip(got["window"]["grads"], want["grads"]):
            _close(g, w, 1e-4)


@pytest.mark.parametrize("j,impl", enumerate(["auto", "flash", "xla"]))
def test_every_impl_goes_around_the_ring_on_row_shards(ranks, j, impl):
    """On row shards (a rank's tokens are its share) every impl takes the
    ring's body: a plain call would attend to the rank's own tokens only."""
    case = ranks["inputs"]["cases"][0]
    want = _plain_grads(case)
    out = torch.cat([g["auto_rows"][j]["out"] for g in ranks["got"]], dim=1)
    _close(out, want["out"], 1e-5)
    for n in range(3):
        got = torch.cat([g["auto_rows"][j]["grads"][n] for g in ranks["got"]],
                        dim=1)
        _close(got, want["grads"][n], 1e-4)


def test_ring_bf16_matches_plain_bf16(ranks):
    b = ranks["inputs"]["bf16"]
    q, k, v = (b[n].to(torch.bfloat16) for n in "qkv")
    want = attention.attention_plain(q, k, v, 32.0 ** -0.5).float()
    for got in ranks["got"]:
        assert got["bf16"].dtype == torch.bfloat16
        np.testing.assert_allclose(got["bf16"].float().numpy(),
                                   want.numpy(), atol=2e-2, rtol=2e-2)


def test_token_count_must_tile_over_the_ring(ranks):
    for got in ranks["got"]:
        assert got["odd_raise"] == (
            "token count 13 must divide over seq axis 'seq' (2)")


def test_nontiling_tokens_warn_and_run_unsharded(ranks):
    """impl="ring" on tokens that do not tile warns as JAX's does and runs
    the unsharded call (the kernels on a CUDA tensor; here the plain
    version)."""
    want = _plain_grads(ranks["inputs"]["odd"])["out"]
    for got in ranks["got"]:
        assert any("does not tile" in w for w in got["odd_warn"])
        _close(got["odd_out"], want, 1e-6)


@pytest.mark.parametrize("name", ["unet", "vit"])
def test_models_with_ring_attention_match_xla(ranks, name):
    """The UNet's AttnBlock and the ViT's heads with attention_impl="ring"
    at two ranks, the whole model on each: the output and every
    parameter's gradient of one process's "xla" model. The gradients of
    the layers before attention are whole only because the tokens' cut
    gathers its gradient back."""
    case = ranks["inputs"]["models"][name]
    want = worker.model_grads(case, "xla")
    # some gradients are 0 but for f32 noise (a bias before a GroupNorm):
    # relative to the model's largest gradient
    scale = max(w.abs().max().item() for w in want["grads"].values())
    for got in ranks["got"]:
        g = got["models"][name]
        _close(g["out"], want["out"], 1e-5)
        assert g["grads"].keys() == want["grads"].keys()
        for k, w in want["grads"].items():
            np.testing.assert_allclose(g["grads"][k].numpy() / scale,
                                       w.numpy() / scale, atol=1e-4,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# one process


def test_one_seq_rank_is_the_local_call(monkeypatch):
    """Without a process group the default layout has one seq rank: the
    ring is the single-device call, bit for bit, and the global view
    too."""
    monkeypatch.delenv("ITSD_ATTN_IMPL", raising=False)
    rng = np.random.default_rng(3)
    c = _case(rng, 2, 16, 8)
    mesh = parallel.default_seq_mesh()
    assert (mesh.data, mesh.seq) == (1, 1)
    want = attention.local_attention(c["q"], c["k"], c["v"])
    for got in (ring.ring_attention(c["q"], c["k"], c["v"], mesh),
                ring.sequence_sharded_attention(c["q"], c["k"], c["v"],
                                                mesh),
                attention.spatial_attention(c["q"], c["k"], c["v"], "ring")):
        assert torch.equal(got, want)


def test_seq_mesh_registry_scopes_and_restores():
    """``seq_mesh_scope`` registers for its body and restores what was
    there (None: a no-op scope); ``make_seq_mesh`` wants a divisor of the
    world size."""
    assert parallel.get_seq_mesh() is None
    mesh = parallel.make_seq_mesh(1)
    with parallel.seq_mesh_scope(mesh):
        assert parallel.get_seq_mesh() is mesh
        with parallel.seq_mesh_scope(None):
            assert parallel.get_seq_mesh() is mesh
    assert parallel.get_seq_mesh() is None
    prev = parallel.set_seq_mesh(mesh)
    assert prev is None and parallel.set_seq_mesh(None) is mesh
    with pytest.raises(ValueError, match="must divide the world size 1"):
        parallel.make_seq_mesh(2)


def test_row_draws_cut_the_global_image():
    """A ``RowDraws`` over a layout of two seq ranks draws for the global
    image and keeps this rank's rows (rank 0: the first half) on the axis
    ``h_axis`` names; an image-shaped draw without it raises; 1-D draws
    (t, label dropout) are cut over the batch only."""
    mesh = SeqMesh(data=1, seq=2)
    g, ref = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    rows = parallel.RowDraws(g, mesh=mesh)
    got = parallel.draw(torch.randn, (2, 3, 4, 1), rows, h_axis=1)
    want = torch.randn((2, 6, 4, 1), generator=ref)[:, :3]
    assert torch.equal(got, want)
    got = parallel.draw(torch.rand, (2, 1, 3, 4), rows, h_axis=2)
    assert torch.equal(got, torch.rand((2, 1, 6, 4), generator=ref)[:, :, :3])
    assert torch.equal(parallel.draw(torch.rand, (2,), rows),
                       torch.rand((2,), generator=ref))
    with pytest.raises(ValueError, match="needs h_axis"):
        parallel.draw(torch.randn, (2, 3, 4, 1), rows)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert spatial.row_shard_mesh() is None
        with spatial.row_shards(mesh):
            assert spatial.row_shard_mesh() is mesh
            with spatial.row_shards(None):
                assert spatial.row_shard_mesh() is None
        assert spatial.row_shard_mesh() is None
