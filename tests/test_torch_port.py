"""The port as a whole: its imports, config, image files, runner and CLI.

The config tree and image grids are compared with the JAX package's for
equality; ``evaluate`` and the CLI run end to end on the CPU at a tiny size.
"""

import ast
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu.utils import make_grid as jax_make_grid
from itsd_tpu.utils import to_dict as jax_to_dict
from itsd_tpu_torch.cli import main as cli_main
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.utils import images, load_config, to_dict

from _torch_port import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "itsd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_gs_repeat.py",
    ROOT / "chip_wide_probe.py", ROOT / "chip_tf32x3_probe.py",
    ROOT / "tests" / "_torch_dist_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "itsd_tpu")

TINY = ["channel=16", "channel_mult=[1,2]", "attn=[1]", "num_res_blocks=1",
        "T=4", "img_size=8", "train.eval_batch_size=2"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        (ROOT / "configs").glob("*.yaml")))
def test_config_loads_as_the_jax_package_does(name):
    path = str(ROOT / "configs" / name)
    assert to_dict(load_config(path)) == jax_to_dict(jax_load_config(path))


def test_overrides_match_the_jax_package():
    ovs = ["T=50", "channel_mult=[1,2]", "diffusion.sampler=ddpm",
           "inference_T=none", "model.dtype=bfloat16", "lr=3e-4",
           "search.launch_segments=2"]
    assert to_dict(load_config(None, ovs)) == jax_to_dict(
        jax_load_config(None, ovs))
    with pytest.raises(KeyError, match="no.such"):
        load_config(None, ["no.such=1"])


def _read_png(data):
    """Decode the 8-bit, non-interlaced, filter-0 PNGs encode_png writes."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    assert depth == 8 and (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, ch)


@pytest.mark.parametrize("channels", [1, 3])
def test_image_grid_and_png_match_the_jax_package(tmp_path, channels):
    rng = np.random.default_rng(channels)
    imgs = rng.uniform(-1, 1, (5, 6, 7, channels)).astype(np.float32)
    grid = images.make_grid(imgs, nrow=3)
    np.testing.assert_array_equal(grid, jax_make_grid(imgs, nrow=3))
    path = tmp_path / "g.png"
    images.save_image_grid(imgs, str(path), nrow=3)
    np.testing.assert_array_equal(_read_png(path.read_bytes()), grid)


def test_png_opens_with_pillow(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    grid = np.random.default_rng(0).integers(0, 256, (9, 11, 3), np.uint8)
    path = tmp_path / "p.png"
    path.write_bytes(images.encode_png(grid))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), grid)


def test_evaluate_on_cpu_writes_both_grids(tmp_path):
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}"])
    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    out = runner.evaluate(cfg, params, device="cpu")
    assert out["images"].shape == (2, 8, 8, 3)
    assert np.isfinite(out["images"]).all()
    assert np.abs(out["images"]).max() <= 1.0
    assert out["path"] == str(tmp_path / "sampled.png")
    assert (tmp_path / "noisy.png").is_file()
    again = runner.evaluate(cfg, params, device="cpu")
    np.testing.assert_array_equal(again["images"], out["images"])


def test_evaluate_loads_a_saved_state_dict(tmp_path):
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}",
                                    f"save_weight_dir={tmp_path}",
                                    "test_load_weight=w.pt"])
    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    torch.save(params, tmp_path / "w.pt")
    a = runner.evaluate(cfg, device="cpu")["images"]
    b = runner.evaluate(cfg, params, device="cpu")["images"]
    np.testing.assert_array_equal(a, b)


def test_evaluate_needs_weights():
    with pytest.raises(ValueError, match="test_load_weight"):
        runner.evaluate(load_config(None, TINY), device="cpu")


@pytest.mark.parametrize("override", [
    "train.spatial_shard=2", "model.backbone=vit", "model.remat=true"])
def test_unported_eval_options_raise(tmp_path, override, capsys):
    """No eval option raises "not yet ported" any more. The ViT backbone
    (patches of 2 on the 8x8 images) and remat evaluate to finite images;
    train.spatial_shard=2 in one process, where a seq axis of 2 does not
    divide the one rank, prints JAX's note and samples what the run
    without it samples (tests/test_torch_spatial.py runs it on two
    ranks)."""
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}", override,
                                    "model.patch_size=2",
                                    "model.embed_dim=32", "model.depth=2",
                                    "model.num_heads=4"])
    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    imgs = runner.evaluate(cfg, params, device="cpu")["images"]
    assert imgs.shape == (2, 8, 8, 3) and np.isfinite(imgs).all()
    assert type(model).__name__ == ("ViT" if "vit" in override else "UNet")
    if override == "train.spatial_shard=2":
        assert ("spatial_shard=2 ignored at inference: needs K | "
                "device_count (1)") in capsys.readouterr().out
        cfg.train.spatial_shard = 1
        want = runner.evaluate(cfg, params, device="cpu")["images"]
        np.testing.assert_array_equal(imgs, want)


@pytest.mark.parametrize("overrides", [
    ["diffusion.sampler=ddim"], ["diffusion.sampler=dpm"],
    ["diffusion.sampler=picard"], ["diffusion.launch_segments=2"],
    ["diffusion.restart_intervals=[[3,1,1]]"],
    ["diffusion.sampler=ddim", "diffusion.ddim_eta=1.0",
     "diffusion.restart_intervals=[[3,1,2]]"]])
def test_fast_sampler_eval_options_run(tmp_path, overrides):
    """The samplers that raised "not yet ported" until they were ported
    run through evaluate (ddim_steps 3 of T=4), unconditional and guided."""
    for base in (TINY, COND):
        cfg = load_config(None, base + [f"sampled_dir={tmp_path}",
                                        "diffusion.ddim_steps=3",
                                        *overrides])
        model, _ = runner.build_model(cfg)
        imgs = runner.evaluate(cfg, runner.init_params(cfg, model),
                               device="cpu")["images"]
        assert imgs.shape == (2, 8, 8, 3) and np.isfinite(imgs).all()
        assert np.abs(imgs).max() <= 1.0


def test_picard_warns_at_world_size_one(tmp_path):
    """On one process Picard is slower than sequential DDIM (the port's
    own measurement on an H100, in the warning); it still samples."""
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}",
                                    "diffusion.sampler=picard",
                                    "diffusion.ddim_steps=3"])
    model, _ = runner.build_model(cfg)
    with pytest.warns(UserWarning, match=r"0\.745x .* 0\.229x under CFG "
                      r"\(.*NVIDIA H100 80GB HBM3 at 700 W"):
        imgs = runner.evaluate(cfg, runner.init_params(cfg, model),
                               device="cpu")["images"]
    assert np.isfinite(imgs).all()
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}",
                                    "diffusion.sampler=ddim",
                                    "diffusion.ddim_steps=3"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        runner.evaluate(cfg, runner.init_params(cfg, model), device="cpu")


@pytest.mark.parametrize("seg_n", [2, 3, 4])
def test_launch_segments_equal_one_chain_bit_for_bit(tmp_path, seg_n):
    """diffusion.launch_segments is accepted for the ancestral chain and
    changes nothing: JAX splits the chain into launches to bound the device
    time of one, here every step is its own launches, so the images equal
    one sample call's bit for bit (T=10)."""
    base = TINY[:-2] + ["T=10", "img_size=8", "train.eval_batch_size=2",
                        f"sampled_dir={tmp_path}",
                        "diffusion.clip_denoised=true"]
    cfg = load_config(None, base)
    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    one = runner.evaluate(cfg, params, device="cpu")["images"]
    seg = runner.evaluate(load_config(None, base + [
        f"diffusion.launch_segments={seg_n}"]), params,
        device="cpu")["images"]
    np.testing.assert_array_equal(seg, one)


@pytest.mark.parametrize("overrides,match", [
    (["diffusion.sampler=ddim", "diffusion.launch_segments=2"],
     "launch_segments"),
    (["diffusion.restart_intervals=[[3,1,1]]", "diffusion.launch_segments=2"],
     "launch_segments"),
    (["diffusion.sampler=picard", "diffusion.restart_intervals=[[3,1,1]]"],
     "picard"),
    (["diffusion.sampler=picard", "diffusion.cfg_interval=[1,3]"],
     "cfg_interval"),
    (["diffusion.restart_intervals=[[5,1,1]]"], "out of range")])
def test_sampler_options_that_cannot_run_raise(tmp_path, overrides, match):
    """Segments of a non-ancestral chain, restart over picard, picard with a
    guidance interval (its sweep evaluates every timestep at once) and a
    restart interval beyond T raise ValueError."""
    cfg = load_config(None, COND + [f"sampled_dir={tmp_path}", *overrides])
    model, _ = runner.build_model(cfg)
    with pytest.raises(ValueError, match=match):
        runner.evaluate(cfg, runner.init_params(cfg, model), device="cpu")


def test_a_checkpoint_of_another_T_is_not_yet_ported(tmp_path, capsys):
    """A table time embedding saved at diffusion.T=10 and sampled at 20
    goes through the cross-T surgery, ported since: evaluate extends the
    checkpoint's table (for the eval weights and for autoguidance's weak
    weights), as if the extended weights were passed in, and the CLI
    exits 0."""
    from itsd_tpu_torch.train.surgery import extend_time_embedding

    keys = COND + ["model.time_embed=table", f"save_weight_dir={tmp_path}",
                   f"sampled_dir={tmp_path}"]
    cfg10 = load_config(None, keys + ["diffusion.T=10"])
    model, _ = runner.build_model(cfg10)
    p10 = _lively_params(cfg10, model)
    torch.save(p10, tmp_path / "t10.pt")
    cfg20 = load_config(None, keys + ["diffusion.T=20"])
    model, _ = runner.build_model(cfg20)
    p20 = _lively_params(cfg20, model)
    torch.save(p20, tmp_path / "t20.pt")
    ext = extend_time_embedding(p10, 20)
    torch.save(ext, tmp_path / "ext.pt")
    for extra, same in ((["test_load_weight=t10.pt"],
                         ["test_load_weight=ext.pt"]),
                        (["test_load_weight=t20.pt", "diffusion.guidance=auto",
                          "diffusion.weak_load_weight=t10.pt"],
                         ["test_load_weight=t20.pt", "diffusion.guidance=auto",
                          "diffusion.weak_load_weight=ext.pt"])):
        got = runner.evaluate(load_config(None, keys + ["diffusion.T=20",
                                                        *extra]),
                              device="cpu")["images"]
        want = runner.evaluate(load_config(None, keys + ["diffusion.T=20",
                                                         *same]),
                               device="cpu")["images"]
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
    rc = cli_main.main(["eval", "--device", "cpu", *keys, "diffusion.T=20",
                        "test_load_weight=t10.pt"])
    assert rc == 0
    assert "not yet ported" not in capsys.readouterr().err


COND = TINY + ["model.num_labels=10", "w=1.8"]


@pytest.mark.parametrize("time_embed", ["table", "functional"])
def test_cond_evaluate_on_cpu_is_the_guided_chain(tmp_path, time_embed):
    """The conditional evaluate samples with CFG (w=1.8) on the labels
    (arange(B) % 10) + 1, from the seed's x_T and noise."""
    from itsd_tpu_torch.core import linear_schedule, sample

    cfg = load_config(None, COND + [f"model.time_embed={time_embed}",
                                    f"sampled_dir={tmp_path}"])
    model, conditional = runner.build_model(cfg)
    assert conditional and model.cfg.time_embed == time_embed
    params = runner.init_params(cfg, model)
    out = runner.evaluate(cfg, params, device="cpu")
    assert out["images"].shape == (2, 8, 8, 3)
    gen = torch.Generator().manual_seed(cfg.seed)
    x_T = torch.randn((2, 8, 8, 3), generator=gen)
    model.eval()
    eps_fn = runner.make_eps_fn(model, True, torch.tensor([1, 2]), 1.8)
    with torch.inference_mode():
        want = sample(linear_schedule(1e-4, 0.02, 4, device="cpu"), eps_fn,
                      x_T, generator=gen)
    np.testing.assert_array_equal(out["images"], want.numpy())


def _lively_params(cfg, model):
    """Seeded weights with the near-zero output layers scaled up to Xavier
    size, so that the labels and the weights move the samples."""
    from itsd_tpu_torch.models.embeddings import TINY_GAIN

    params = runner.init_params(cfg, model)
    for k, v in params.items():
        if k.endswith(("conv2.weight", "proj.weight", "tail_conv.weight")):
            v.mul_(1 / TINY_GAIN)
    return params


def test_cond_evaluate_with_an_interval_and_autoguidance(tmp_path):
    cfg = load_config(None, COND + [f"sampled_dir={tmp_path}"])
    model, _ = runner.build_model(cfg)
    torch.save(_lively_params(cfg, model), tmp_path / "strong.pt")
    weak_cfg = load_config(None, COND + ["seed=1"])
    torch.save(_lively_params(weak_cfg, model), tmp_path / "weak.pt")
    base = COND + [f"sampled_dir={tmp_path}", f"save_weight_dir={tmp_path}",
                   "test_load_weight=strong.pt"]
    runs = {}
    for name, extra in (("cfg", []), ("interval", [
            "diffusion.cfg_interval=[1,3]"]), ("auto", [
                "diffusion.guidance=auto",
                "diffusion.weak_load_weight=weak.pt"])):
        imgs = runner.evaluate(load_config(None, base + extra),
                               device="cpu")["images"]
        assert np.isfinite(imgs).all()
        runs[name] = imgs
    assert not np.array_equal(runs["cfg"], runs["interval"])
    assert not np.array_equal(runs["cfg"], runs["auto"])


@pytest.mark.parametrize("override,error,match", [
    ("diffusion.guidance=autoguidance", ValueError, "unknown diffusion"),
    ("diffusion.guidance=auto", ValueError, "weak_load_weight"),
    ("diffusion.cfg_interval=[3,1]", ValueError, "reversed"),
    ("diffusion.inference_T=3", ValueError, "unknown strategy")])
def test_guided_eval_options_raise_before_sampling(tmp_path, override, error,
                                                  match):
    """A guidance value other than cfg | auto (which the JAX package reads
    as cfg), autoguidance without a weak checkpoint, a reversed interval,
    and another inference_T for a table time embedding with an unknown
    ``train.time_embedding_strategy`` (the cross-T surgery reads it only
    when it resizes the table) all raise."""
    base = COND + ["model.time_embed=table", f"sampled_dir={tmp_path}",
                   "train.time_embedding_strategy=nearest"]
    cfg = load_config(None, base)
    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    with pytest.raises(error, match=match):
        runner.evaluate(load_config(None, base + [override]), params,
                        device="cpu")


@pytest.mark.parametrize("strategy", ["interpolate", "reinit"])
def test_cond_eval_at_another_inference_T_extends_the_table(tmp_path,
                                                           strategy):
    """A table time embedding of T=4 sampled at inference_T=7: the model
    that samples has 7 rows, the weights are extended by the configured
    strategy, and the chain is the guided chain on those weights."""
    from itsd_tpu_torch.train.surgery import extend_time_embedding

    base = COND + ["model.time_embed=table", f"sampled_dir={tmp_path}",
                   f"train.time_embedding_strategy={strategy}"]
    cfg = load_config(None, base)
    model, _ = runner.build_model(cfg)
    params = _lively_params(cfg, model)
    cfg7 = load_config(None, base + ["diffusion.inference_T=7"])
    got = runner.evaluate(cfg7, params, device="cpu")["images"]
    model7, _ = runner.build_model(cfg7, inference=True)
    assert model7.time_embedding.table.shape[0] == 7
    assert runner.build_model(cfg7)[0].time_embedding.table.shape[0] == 4
    want = runner.evaluate(load_config(None, base + ["T=7"]),
                           extend_time_embedding(params, 7, strategy),
                           device="cpu")["images"]
    np.testing.assert_array_equal(got, want)


def test_yaml_reader_matches_pyyaml_on_every_config():
    yaml = pytest.importorskip("yaml")
    from itsd_tpu_torch.utils.config import read_yaml

    for path in sorted((ROOT / "configs").glob("*.yaml")):
        text = path.read_text()
        assert read_yaml(text) == (yaml.safe_load(text) or {}), path.name
    text = ("a: 1e-4\nb:\n  c: [1, 2.5, x]  # note\n  d: 'q: r'\n"
            "e: ~\nf: yes\n")
    assert read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: {b: 1}\n",
                                  "  a: 1\n", "a\n", "a:\n  b: 1\n c: 2\n"])
def test_yaml_reader_rejects_what_it_does_not_read(text):
    from itsd_tpu_torch.utils.config import read_yaml

    with pytest.raises(ValueError):
        read_yaml(text)


def test_unknown_sampler_raises(tmp_path):
    cfg = load_config(None, TINY + [f"sampled_dir={tmp_path}",
                                    "diffusion.sampler=euler"])
    model, _ = runner.build_model(cfg)
    with pytest.raises(ValueError, match="unknown diffusion.sampler"):
        runner.evaluate(cfg, runner.init_params(cfg, model), device="cpu")


def test_cli_eval_on_cpu(tmp_path, capsys):
    cfg = load_config(None, TINY)
    model, _ = runner.build_model(cfg)
    torch.save(runner.init_params(cfg, model), tmp_path / "w.pt")
    rc = cli_main.main(["eval", "--device", "cpu", *TINY,
                        f"save_weight_dir={tmp_path}",
                        "test_load_weight=w.pt", f"sampled_dir={tmp_path}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"sampled grid: {tmp_path / 'sampled.png'}" in out


def test_cli_takes_overrides_after_its_options():
    """Overrides may follow --config and --device (the card's Python 3.12
    release rejected them there with argparse's plain parser)."""
    args = cli_main._parse(["inference-metrics", "--config", "c.yaml",
                            "--device", "cpu", "T=4", "seed=1"])
    assert (args.command, args.config, args.device, args.overrides) == (
        "inference-metrics", "c.yaml", "cpu", ["T=4", "seed=1"])
    args = cli_main._parse(["eval", "T=4", "--device", "cpu", "seed=1"])
    assert args.overrides == ["T=4", "seed=1"]


@pytest.mark.parametrize("command", ["train", "search", "finetune-t",
                                     "inference-metrics"])
def test_cli_other_commands_are_not_ported(command, capsys, tmp_path,
                                           monkeypatch):
    """Every command is ported and raises its real error: train on the
    default config (tracked metrics on, CIFAR-10) finds no dataset, search
    with the CLIP verifier no CLIP weights, finetune-t and
    inference-metrics no checkpoint."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ITSD_CLIP_WEIGHTS", raising=False)
    args = [command]
    if command == "search":
        cfg = load_config(None, TINY)
        model, _ = runner.build_model(cfg)
        torch.save(runner.init_params(cfg, model), tmp_path / "w.pt")
        args += ["--device", "cpu", *TINY, f"save_weight_dir={tmp_path}",
                 "test_load_weight=w.pt", "search.verifier=clip"]
    error, match = {
        "train": (FileNotFoundError, "CIFAR-10 not found"),
        "search": (ValueError, "needs CLIP weights"),
        "finetune-t": (ValueError, "needs test_load_weight"),
        "inference-metrics": (ValueError, "needs test_load_weight"),
    }[command]
    with pytest.raises(error, match=match):
        cli_main.main(args + ["--device", "cpu"] * (command != "search"))
    assert "not yet ported" not in capsys.readouterr().err
