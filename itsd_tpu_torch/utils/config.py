"""One dataclass config tree + YAML + dotted-key CLI overrides.

A copy of ``itsd_tpu/utils/config.py`` for the port, which imports nothing of
the JAX package. YAML files are read by ``read_yaml``, a reader of the
subset of YAML the configs use (nested mappings, scalars, flow lists), which
resolves scalars as ``yaml.safe_load`` does, so configs load where PyYAML
is not installed (the card's machine).

Key names match the reference DDPM code's config.yaml: T, inference_T,
beta_1, beta_T, channel, channel_mult, attn, num_res_blocks, dropout, w,
epoch, batch_size, lr, multiplier, grad_clip, img_size, ...

String coercion mirrors `Main.py:38-60`: "none"/"null" -> None,
"true"/"false" -> bool, numeric strings -> numbers.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelCfg:
    backbone: str = "unet"              # "unet" | "vit"
    channel: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    attn: Tuple[int, ...] = (2,)
    num_res_blocks: int = 2
    dropout: float = 0.15
    num_labels: Optional[int] = None    # None => unconditional
    time_embed: str = "functional"      # "functional" | "table"
    dtype: str = "float32"              # "bfloat16" for TPU perf runs
    attention_impl: str = "auto"
    # ViT-only knobs (`Model.py:357-380`)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    # per-block remat (ViT TransformerBlocks / UNet ResBlocks): recompute
    # activations in the backward pass — trades FLOPs for the HBM that
    # caps large-image train batches (docs/PERF.md)
    remat: bool = False


@dataclasses.dataclass
class DiffusionCfg:
    T: int = 1000
    inference_T: Optional[int] = None   # None => use training T
    beta_1: float = 1e-4
    beta_T: float = 0.02
    w: float = 0.0                      # CFG guidance weight
    sampler: str = "ddpm"       # "ddpm" (ancestral) | "ddim" | "dpm" | "picard"
    ddim_steps: int = 50        # step/grid budget for ddim, dpm, picard
    ddim_eta: float = 0.0
    # clip the per-step x0-hat to [-1,1] in the ancestral sampler — bounds
    # the chain on long extrapolative-CFG runs (T=3000, w=1.8), where the
    # unclipped state can grow without bound (core/process.p_sample_step)
    clip_denoised: bool = False
    # restrict classifier-free guidance to timesteps lo <= t < hi
    # (Kynkaanniemi et al. 2024): outside the interval each step runs ONE
    # conditional forward instead of the dual-batched pair — a quality
    # knob AND an NFE saving (core.process.cfg_nfes). None/() = guide the
    # whole chain (the reference's behavior).
    cfg_interval: Optional[Tuple[int, int]] = None
    # Guidance flavor for conditional sampling:
    #   "cfg"  — classifier-free guidance: (1+w)*eps_cond - w*eps_uncond,
    #            one dual-batched forward (the reference's behavior);
    #   "auto" — autoguidance (Karras et al. 2024, arXiv 2406.02507):
    #            (1+w)*eps_strong - w*eps_weak, BOTH conditional, the weak
    #            model loaded from `weak_load_weight` (an under-trained
    #            checkpoint of the same architecture). Same 2-evals/step
    #            cost; `cfg_interval` applies to either.
    guidance: str = "cfg"
    # checkpoint name (under save_weight_dir) of the WEAK model for
    # guidance="auto"; loaded exactly like test_load_weight (full or
    # weights-only checkpoints, cross-T surgery applied)
    weak_load_weight: Optional[str] = None
    # restart sampling (Xu et al. 2023): ((t_max, t_min, k), ...) —
    # re-noise + re-denoise each interval k extra times, riding whatever
    # base `sampler` family is selected (ddpm/ddim/dpm; not picard).
    # Empty = off. Third scaling axis; see core.sampling.restart_sample.
    restart_intervals: tuple = ()
    # Device launches the T-step ancestral chain is split into (1 = whole
    # chain in one launch). One batch x T=1000 launch of a ch=128 256x256
    # UNet runs minutes of DEVICE time, which TPU-worker watchdogs kill
    # mid-flight; segmented launches chain bit-identically (the scan's
    # carried PRNG key crosses launches). Honored by `eval`'s sampler and
    # by random search; requires sampler=ddpm without restart_intervals
    # (fast samplers run few steps per launch anyway).
    launch_segments: int = 1


@dataclasses.dataclass
class TrainCfg:
    epoch: int = 10
    batch_size: int = 128
    lr: float = 1e-4
    multiplier: float = 2.0
    grad_clip: float = 1.0
    weight_decay: float = 1e-4
    ema_decay: Optional[float] = 0.999
    loss_reduction: str = "mean"        # "sum_div_b2" for CFG parity
    # "min_snr": Min-SNR-gamma weighting (Hang et al. 2023) — faster
    # quality convergence per step; "none" = reference-parity uniform MSE
    loss_weighting: str = "none"
    snr_gamma: float = 5.0
    label_dropout: float = 0.1
    eval_freq: int = 5
    model_save_freq: int = 5
    metric_interval: int = 10
    # metric interval during EVALUATION runs (config.yaml
    # `eval_metric_interval`); None = metric_interval
    eval_metric_interval: Optional[int] = None
    # real FID/CLIP features from the val split (True, reference default)
    # or from the training set (config.yaml `use_val_for_eval: false`)
    use_val_for_eval: bool = True
    # accepted for config.yaml compat; this implementation ALWAYS
    # precomputes real features once before the loop (recomputing per
    # epoch is a torch-GPU-memory workaround, `Train.py:210-244`)
    precompute_real_features: bool = False
    is_splits: int = 10                 # IS split count (`metrics.py:377-417`)
    # Logit source for tracked Inception-Score-style metrics:
    #   "inception" — the Inception-V3 head (reference behavior; with
    #                 random weights its IS is a constant 1.0 — plumbing
    #                 signal only);
    #   "auto"      — pretrained Inception when available, else a trained
    #                 SmallCNN checkpoint at
    #                 <save_weight_dir>/classifier_<dataset><img_size>
    #                 (dataset-specific IS with real signal), else
    #                 Inception as-is;
    #   <path>      — an explicit SmallCNN checkpoint directory.
    is_logit_source: str = "auto"
    eval_batch_size: Optional[int] = None
    fid_num_real_samples: int = 5000
    clip_num_real_samples: int = 5000
    # metric-tracked sampling against a val split every `eval_freq` epochs
    # during training (`Train.py:516-536,719-803`). None = auto: ON for
    # every dataset except the test-only "synthetic" blobs — matching the
    # reference, which always evaluates during training. Set false to skip
    # the per-eval sampler cost explicitly.
    track_metrics: Optional[bool] = None
    # checkpoint saves run in a background thread (Orbax async); the
    # reference blocks on torch.save each epoch
    async_checkpoint: bool = True
    # host batch prep + device_put on a producer thread (overlaps the
    # training step's Python dispatch; the reference uses DataLoader
    # worker processes for the same purpose, Train.py:512-514)
    threaded_input: bool = True
    # capture a jax.profiler trace of the first N train steps into
    # `<metrics_save_dir>/trace` (0 disables)
    profile_steps: int = 0
    # spatial partitioning: shard image ROWS over a 'seq' mesh axis of
    # this size (data axis gets device_count/spatial_shard). Memory lever
    # ONLY when the data axis is exhausted (batch <= data shards: per-chip
    # activations ~1/K, measured); at fixed global batch it saves nothing
    # (docs/PERF.md "The memory claim, MEASURED"). Composes with
    # model.attention_impl=ring on the same axis. 1 disables.
    spatial_shard: int = 1
    # PRNG implementation for the training key stream. "rbg" uses the
    # TPU-native non-cryptographic generator — measured 28% step-throughput
    # gain on dropout-heavy models (the ViT: threefry mask bits poison the
    # matmul fusions, docs/PERF.md "ViT denoiser"); changes the random
    # stream, so seeded runs are not comparable across impls
    prng_impl: str = "threefry"
    training_load_weight: Optional[str] = None
    # representation extraction during training (TrainCondition.py:66-107);
    # 0 disables
    extract_representation_freq: int = 0
    save_representations: bool = True
    # T-extension fine-tune
    fine_tune_lr: float = 1e-5
    freeze_except_time_embedding: bool = False
    time_embedding_strategy: str = "interpolate"  # | "reinit"


@dataclasses.dataclass
class DataCfg:
    dataset: str = "cifar10"            # "cifar10" | "imagefolder" | "synthetic"
    root: str = "./datasets"
    img_size: int = 32
    use_full_dataset: bool = True
    train_subset_ratio: float = 1.0
    # fraction held out as the val split for real-feature FID/CLIP stats
    # during metric-tracked training eval (`Train.py:516-536`)
    val_ratio: float = 0.1
    seed: int = 0


@dataclasses.dataclass
class SearchCfg:
    algorithm: str = "random"  # random|zero_order|path|pruned|smc|gradient
    verifier: str = "oracle"            # oracle|self_supervised|aesthetic|classifier|ensemble
    n_candidates: int = 4
    # Random search: candidates evaluated per device launch (None = all at
    # once). Chunking bounds per-launch runtime/memory — huge searches
    # (e.g. best-of-64 at T=3000) otherwise run one multi-minute XLA
    # program, which device watchdogs can kill. Must divide n_candidates.
    candidate_chunk: Optional[int] = None
    n_neighbors: int = 4
    lambda_radius: float = 0.95
    n_iterations: int = 10
    neighbor_mode: str = "additive"     # | "shell"
    n_paths: int = 4
    n_active: int = 2
    injection_steps: Tuple[int, ...] = (400,)
    delta_f: int = 50
    # algorithm=pruned: ((t, keep), ...) — denoise all n_candidates
    # together, score x0-hat at each t and keep the top `keep`
    # (successive halving over noise; `[[500,4]]` on the CLI)
    prune_schedule: Tuple = ((500, 4),)
    # algorithm=smc (Feynman-Kac steering): n_candidates particles carry
    # log-weights lambda * (score_t - score_prev) on the x0-hat verifier
    # score at each smc_resample_steps point, and are systematically
    # resampled (weak die, strong multiply — population size constant) when
    # the effective sample size drops below smc_ess_threshold * N.
    # lambda 0 = untilted ancestral sampling, ->inf = greedy selection.
    smc_resample_steps: Tuple[int, ...] = (700, 400, 150)
    smc_lambda: float = 10.0
    smc_ess_threshold: float = 0.5
    # "absolute": log-weights lambda*(score_t - score_prev) — the exact
    # Feynman-Kac tilt exp(lambda*score), but lambda rides the verifier's
    # score scale (measured: lambda>=2 fully collapses a classifier-scored
    # population, docs/results/smc_budget.json). "spread": increments are
    # z-scored over the population first, so lambda is dimensionless
    # selection pressure transferring across verifiers.
    smc_lambda_scale: str = "absolute"  # absolute|spread
    gradient_lr: float = 0.01
    # verifier=classifier: weights-only checkpoint of a SmallCNN (path
    # relative to save_weight_dir, or absolute); architecture is inferred
    # from the checkpoint (models/classifier.py:load_classifier)
    classifier_ckpt: Optional[str] = None
    # class the classifier verifier rewards; None = the sampler's own label
    # cycle for conditional models (required for unconditional ones)
    target_label: Optional[int] = None
    # verifier=clip: .npy of precomputed text features [D] or [B,D]
    # (encode once with metrics.clip.encode_texts; None scores mean image-
    # feature norm as the no-prompt quality proxy, `verifier.py:163-188`)
    clip_text_features: Optional[str] = None
    # verifier=ensemble: score = -FID(vs real stats) + is_weight * IS,
    # all on-device inside the jitted search
    ensemble_is_weight: float = 10.0
    ensemble_num_real: int = 64         # real images anchoring the FID stats
    # Verifier-hacking guard (the paper's own failure mode, demonstrated
    # in docs/RESULTS.md at path-64): after search, score the winner batch
    # with an INDEPENDENT FID-proxy (pooled-pixel Frechet vs real stats)
    # against an unsearched baseline sample from the same denoiser, and
    # warn when the winner is guard_ratio x worse — the verifier was
    # over-optimized at the expense of sample quality
    guard_proxy: bool = False
    guard_num_real: int = 256           # real images anchoring proxy stats
    guard_ratio: float = 1.5
    # independent seeded unsearched draws pooled into the baseline proxy —
    # at eval_bs=4-8 a single draw's Frechet-proxy stats are high-variance
    # and flagged/not-flagged could flip on sampling noise
    guard_baseline_draws: int = 4


@dataclasses.dataclass
class Config:
    state: str = "train"                # train | eval | search
    seed: int = 0
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    diffusion: DiffusionCfg = dataclasses.field(default_factory=DiffusionCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)
    data: DataCfg = dataclasses.field(default_factory=DataCfg)
    search: SearchCfg = dataclasses.field(default_factory=SearchCfg)
    save_weight_dir: str = "./checkpoints"
    sampled_dir: str = "./sampled"
    metrics_save_dir: str = "./metrics_curves"
    test_load_weight: Optional[str] = None
    nrow: int = 8
    # eval grid filenames (config.yaml `sampledNoisyImgName` /
    # `sampledImgName`)
    sampled_noisy_img_name: str = "noisy.png"
    sampled_img_name: str = "sampled.png"


def coerce(value: str) -> Any:
    """'none'->None, 'true'/'false'->bool, numbers->numbers; else str.
    Mirrors the legacy-string handling at `Main.py:38-60`."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low in ("none", "null"):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("[") or value.startswith("("):
        try:
            return tuple(json.loads(value.replace("(", "[").replace(")", "]")))
        except json.JSONDecodeError:
            pass
    return value


def _set_dotted(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config key: {dotted!r}")
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config key: {dotted!r}")
    current = getattr(obj, name)
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    setattr(obj, name, value)


_LEGACY_MAP = {
    # flat reference keys -> our tree (so reference-style overrides work)
    "T": "diffusion.T",
    "inference_T": "diffusion.inference_T",
    "beta_1": "diffusion.beta_1",
    "beta_T": "diffusion.beta_T",
    "w": "diffusion.w",
    "channel": "model.channel",
    "channel_mult": "model.channel_mult",
    "attn": "model.attn",
    "num_res_blocks": "model.num_res_blocks",
    "dropout": "model.dropout",
    "epoch": "train.epoch",
    "batch_size": "train.batch_size",
    "lr": "train.lr",
    "multiplier": "train.multiplier",
    "grad_clip": "train.grad_clip",
    "img_size": "data.img_size",
    "imagenet_root": "data.root",
    "train_subset_ratio": "data.train_subset_ratio",
    "use_full_dataset": "data.use_full_dataset",
    "eval_freq": "train.eval_freq",
    "metric_interval": "train.metric_interval",
    "model_save_freq": "train.model_save_freq",
    "training_load_weight": "train.training_load_weight",
    "fine_tune_lr": "train.fine_tune_lr",
    "time_embedding_strategy": "train.time_embedding_strategy",
    "eval_batch_size": "train.eval_batch_size",
    "fid_num_real_samples": "train.fid_num_real_samples",
    "is_logit_source": "train.is_logit_source",
    "clip_num_real_samples": "train.clip_num_real_samples",
    "eval_metric_interval": "train.eval_metric_interval",
    "use_val_for_eval": "train.use_val_for_eval",
    "precompute_real_features": "train.precompute_real_features",
    "sampledNoisyImgName": "sampled_noisy_img_name",
    "sampledImgName": "sampled_img_name",
    # inference/fine-tune configs (`config/inference_config.yaml`,
    # `config/fine_tune_config.yaml`)
    "checkpoint_path": "test_load_weight",
    "sampled_images_save_dir": "sampled_dir",
    "fine_tune_epochs": "train.epoch",
    "fine_tune_time_embedding": "train.freeze_except_time_embedding",
    # moved knobs (old dotted key -> new home); committed round-3/4
    # measurement provenance and scripts still use the old spelling
    "search.launch_segments": "diffusion.launch_segments",
}

# Reference keys with no TPU equivalent — accepted and dropped with a note
# so the reference's own YAML files load unchanged (KeyError would reject
# them; silent dropping would hide real typos, hence the stderr note).
_IGNORED_KEYS = {
    "hydra": "Hydra runtime section",
    "device": "the device is the CLI's --device argument",
    "device_ids": "multi-chip runs use jax.sharding meshes",
    "use_multi_gpu": "multi-chip runs use jax.sharding meshes",
    "num_workers": "host input uses train.threaded_input",
    "fine_tune_mode": "the finetune-t CLI subcommand selects the mode",
    "output_dir": "inference artifacts go to metrics_save_dir/sampled_dir",
}


def _note_ignored(key: str) -> None:
    import sys
    print(f"[config] ignoring reference-only key {key!r} "
          f"({_IGNORED_KEYS[key]})", file=sys.stderr)


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``key=value`` strings (dotted or legacy-flat reference keys)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        if key in _IGNORED_KEYS:
            _note_ignored(key)
            continue
        key = _LEGACY_MAP.get(key, key)
        _set_dotted(cfg, key, coerce(raw))
    return cfg


def _update_dataclass(obj: Any, data: dict, prefix: str = "",
                      root: Any = None) -> None:
    root = obj if root is None else root
    for k, v in data.items():
        if prefix == "" and k in _IGNORED_KEYS:
            _note_ignored(k)
            continue
        # moved knobs under a NESTED yaml section (e.g. `search:` ->
        # `launch_segments:`) remap by their full dotted path, on the root
        moved = _LEGACY_MAP.get(f"{prefix}{k}")
        if prefix and moved:
            _set_dotted(root, moved, coerce(v) if isinstance(v, str) else v)
            continue
        k = _LEGACY_MAP.get(k, k) if prefix == "" else k
        if "." in k:
            _set_dotted(obj, k, coerce(v) if isinstance(v, str) else v)
            continue
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {prefix}{k!r}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v, prefix=f"{prefix}{k}.", root=root)
        else:
            v = coerce(v) if isinstance(v, str) else v
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(obj, k, v)


# Scalars as PyYAML's resolver (YAML 1.1) reads them: a float needs a dot
# (so "1e-4" stays a string, as under yaml.safe_load), and yes/no/on/off
# are booleans.
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|"
                        r"False|FALSE|on|On|ON|off|Off|OFF)$")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*"
                         r"(?:[eE][-+][0-9]+)?$")


def _yaml_scalar(text: str, where: str) -> Any:
    if text[:1] in "\"'":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"{where}: unterminated string {text!r}")
        return text[1:-1]
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated list {text!r}")
        body = text[1:-1].strip()
        return [_yaml_scalar(v.strip(), where)
                for v in body.split(",")] if body else []
    if text[0] in "{&*!|>%@`" or text[:2] in ("- ", "? "):
        raise ValueError(f"{where}: YAML construct {text!r} is not read")
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (a ``#`` outside quotes,
    at the start or after a space)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(text: str) -> dict:
    """The mapping a config file holds: nested ``key: value`` mappings by
    indentation (the top level at column 0), with null, bool, int, float
    and string scalars, quoted strings and one-line flow lists. Anything
    else raises."""
    root: dict = {}
    stack = [(0, root)]  # (indent of a mapping's keys, the mapping)
    pending = None       # (mapping, key) of a "key:" line with no value
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent] == "\t":
            raise ValueError(f"line {n}: tabs are not read")
        if pending is not None and indent > stack[-1][0]:
            parent, key = pending  # the key's value is the mapping below
            parent[key] = {}
            stack.append((indent, parent[key]))
        pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {n}: unexpected indentation")
        key, sep, value = line.strip().partition(":")
        if not sep or not key or (value and value[0] not in " \t"):
            raise ValueError(f"line {n}: want 'key: value', got "
                             f"{line.strip()!r}")
        key, value = key.strip(), value.strip()
        mapping = stack[-1][1]
        mapping[key] = _yaml_scalar(value, f"line {n}") if value else None
        if not value:
            pending = (mapping, key)
    return root


def load_config(yaml_path: Optional[str] = None,
                overrides: Sequence[str] = ()) -> Config:
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as f:
            data = read_yaml(f.read())
        _update_dataclass(cfg, data)
    apply_overrides(cfg, overrides)
    return cfg


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
