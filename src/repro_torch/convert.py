"""Turn the reference package's parameters, given as numpy or plain data,
into the port's objects and tensors (so both packages can be fed the
same inputs)."""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from . import device as _device
from .core.platform import PlatformSpec
from .kernels.day_scan import ROW_KEYS, TABLE_KEYS


def platform_from_dict(d: dict) -> PlatformSpec:
    """A port `PlatformSpec` from the reference's `PlatformSpec.to_dict()`."""
    return PlatformSpec.from_dict(d)


def theta_from_numpy(theta: dict, device="cuda") -> dict:
    """A theta dict (names -> numbers or 0-dim arrays) as the engine's
    0-dim float32 tensors on `device`."""
    dev = _device.resolve(device)
    return {k: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=dev) for k, v in theta.items()}


def tables_from_numpy(tables: dict, device="cuda") -> dict:
    """The reference's batched day tables (`daysim.batch_tables` layout:
    (N, T, L) level tables, (N, T) step rows, (N, L) act_mult, const dict
    of (N,)) as the port's time-major day-scan tables on `device`:
    (T, L, N), (T, N), (L, N) and (N,) float32 tensors.  Entries the day
    scan does not read (per-stream pods) are dropped."""
    dev = _device.resolve(device)

    def put(a, perm=None):
        a = np.array(a, np.float32)          # a writable copy
        if perm is not None:
            a = np.transpose(a, perm)
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    out = {k: put(tables[k], (1, 2, 0)) for k in TABLE_KEYS}
    out.update({k: put(tables[k], (1, 0)) for k in ROW_KEYS})
    out["act_mult"] = put(tables["act_mult"], (1, 0))
    out["const"] = {k: put(v) for k, v in tables["const"].items()}
    return out


# ---------------------------------------------------------------------------
# language-model parameters
# ---------------------------------------------------------------------------

# float32 whatever the param dtype: the SSM's A_log / D / dt_bias and the
# MoE router
F32_LEAVES = ("A_log", "D", "dt_bias", "router")
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
_BLOCK = 1 << 22            # elements of one seeded block (transformer tree)


def _trunc_normal(rng, out: np.ndarray, std: float) -> np.ndarray:
    """Fill `out` (float32) with Normal(0, std) truncated at 2 std, one
    leading-axis slice at a time (bounded temporaries at full width)."""
    for part in (out if out.ndim > 2 else [out]):
        x = rng.standard_normal(part.shape, dtype=np.float32)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(x) > 2.0
        np.multiply(x, np.float32(std), out=part)
    return out


def _trunc_normal_blocks(seed: int, leaf: int, shape, std: float,
                         pool) -> np.ndarray:
    """A float32 array of `shape`, Normal(0, std) truncated at 2 std,
    drawn in blocks of `_BLOCK` elements, block b from its own stream
    (seed, leaf, b), the blocks filled in parallel on `pool`'s threads
    (numpy's generators release the GIL).  The values depend on the seed,
    the leaf number and the shape only."""
    out = np.empty(shape, np.float32)
    flat = out.reshape(-1)

    def fill(b):
        part = flat[b * _BLOCK:(b + 1) * _BLOCK]
        # repro: ignore[R003]: the reference-parity weight draw: one numpy
        # stream per (seed, leaf, block), so a tree depends on the seed alone
        # (convert.lm_params_numpy)
        _trunc_normal(np.random.default_rng([seed, leaf, b]), part[None],
                      std)

    list(pool.map(fill, range(-(-flat.size // _BLOCK))))
    return out


def transformer_params_numpy(cfg, seed: int) -> dict:
    """Seeded numpy parameters of `models.transformer` with the shapes
    and scales of the reference's `transformer.init`: dense layers
    Normal(0, 1/sqrt(fan_in)) (`dense_init`'s fan_in: the first axis of a
    layer's leaf, or the one the reference names), the embedding Normal(0,
    1), both truncated at 2 std; RMSNorm scales ones, non-parametric
    norms `{}`; the MoE router (D, E); `patch_proj` (vision_embed_dim, D).
    All float32, layer leaves stacked on a leading axis.  Leaves are
    numbered in a fixed order and each is drawn by
    `_trunc_normal_blocks`, so the tree depends on the seed alone."""
    from concurrent.futures import ThreadPoolExecutor
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    H, K, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    counter = iter(range(1 << 30))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:

        def dense(shape, fan_in):
            return _trunc_normal_blocks(seed, next(counter), shape,
                                        1.0 / math.sqrt(max(fan_in, 1)),
                                        pool)

        def norm(*shape):
            return {} if cfg.norm == "nonparametric_ln" else \
                {"scale": np.ones(shape, np.float32)}

        layers = {
            "norm1": norm(L, d),
            "attn": {"wq": dense((L, d, H, Dh), d),
                     "wk": dense((L, d, K, Dh), d),
                     "wv": dense((L, d, K, Dh), d),
                     "wo": dense((L, H, Dh, d), H * Dh)},
            "norm2": norm(L, d),
        }
        if cfg.n_experts:
            E = cfg.n_experts
            layers["moe"] = {"router": dense((L, d, E), d),
                             "wi": dense((L, E, d, F), d),
                             "wg": dense((L, E, d, F), d),
                             "wo": dense((L, E, F, d), F)}
        else:
            layers["mlp"] = {"wi": dense((L, d, F), d),
                             "wo": dense((L, F, d), F),
                             "wg": dense((L, d, F), d)}
        params = {"embed": {"table": dense((V, d), 1)},
                  "layers": layers, "final_norm": norm(d)}
        if cfg.vision_tokens:
            params["patch_proj"] = dense((cfg.vision_embed_dim, d),
                                         cfg.vision_embed_dim)
    return params


def whisper_params_numpy(cfg, seed: int) -> dict:
    """Seeded numpy parameters of `models.whisper` with the shapes and
    scales of the reference's `whisper.init`: dense layers Normal(0,
    1/sqrt(fan_in)), the embedding Normal(0, 1), `pos_embed` (audio_frames,
    D) Normal(0, 0.02), all truncated at 2 std; RMSNorm scales ones; the
    MLPs ungated (`wi`, `wo`).  Encoder and decoder layers stacked on a
    leading axis (`enc_layers`, `dec_layers`; a decoder layer adds
    `norm_x` and the cross-attention `xattn`).  float32; leaves drawn as
    `transformer_params_numpy` draws them."""
    from concurrent.futures import ThreadPoolExecutor
    d, V, F = cfg.d_model, cfg.vocab, cfg.d_ff
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    counter = iter(range(1 << 30))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:

        def normal(shape, std):
            return _trunc_normal_blocks(seed, next(counter), shape, std,
                                        pool)

        def dense(shape, fan_in):
            return normal(shape, 1.0 / math.sqrt(max(fan_in, 1)))

        def attn(L):
            return {"wq": dense((L, d, H, Dh), d),
                    "wk": dense((L, d, K, Dh), d),
                    "wv": dense((L, d, K, Dh), d),
                    "wo": dense((L, H, Dh, d), H * Dh)}

        def layers(L, dec: bool):
            out = {"norm1": {"scale": np.ones((L, d), np.float32)},
                   "attn": attn(L),
                   "norm2": {"scale": np.ones((L, d), np.float32)},
                   "mlp": {"wi": dense((L, d, F), d),
                           "wo": dense((L, F, d), F)}}
            if dec:
                out["norm_x"] = {"scale": np.ones((L, d), np.float32)}
                out["xattn"] = attn(L)
            return out

        return {"embed": {"table": dense((V, d), 1)},
                "pos_embed": normal((cfg.audio_frames, d), 0.02),
                "enc_layers": layers(cfg.n_layers, False),
                "enc_norm": {"scale": np.ones(d, np.float32)},
                "dec_layers": layers(cfg.dec_layers, True),
                "final_norm": {"scale": np.ones(d, np.float32)}}


def lm_params_numpy(cfg, seed: int) -> dict:
    """Seeded numpy parameters of `cfg`'s model: the transformer families
    through `transformer_params_numpy`, the encoder-decoder through
    `whisper_params_numpy`; the SSM and hybrid families here,
    as `models.mamba_lm`'s tree with the shapes and scales of the
    reference's `mamba_lm.init` / `ssd.mamba2_init`: dense layers
    Normal(0, 1/sqrt(fan_in)) and the embedding Normal(0, 1), both
    truncated at 2 std; conv_w over sqrt(d_conv); A_log = log(1 + 15 U);
    dt_bias the inverse softplus of a log-uniform dt in [dt_min, dt_max];
    D, norm scales ones; conv_b zeros.  All float32, layer leaves stacked
    on a leading axis.  Each leaf has its own stream (seed, leaf number),
    so the tree does not depend on the order leaves are read in."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer_params_numpy(cfg, seed)
    if cfg.family == "encdec":
        return whisper_params_numpy(cfg, seed)
    s, n_l, d = cfg.ssm, cfg.n_layers, cfg.d_model
    di, h = s.d_inner, s.n_heads
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + h
    counter = iter(range(1 << 30))

    def rng():
        # repro: ignore[R003]: the reference-parity weight draw: one numpy
        # stream per (seed, leaf)
        return np.random.default_rng([seed, next(counter)])

    def dense(shape, fan_in):
        return _trunc_normal(rng(), np.empty(shape, np.float32),
                             1.0 / math.sqrt(max(fan_in, 1)))

    def ones(*shape):
        return np.ones(shape, np.float32)

    dt = np.exp(rng().uniform(size=(n_l, h))
                * (math.log(s.dt_max) - math.log(s.dt_min))
                + math.log(s.dt_min))
    params = {
        "embed": {"table": dense((cfg.vocab, d), 1)},
        "layers": {
            "norm": {"scale": ones(n_l, d)},
            "mamba": {
                "in_proj": dense((n_l, d, proj_out), d),
                "conv_w": _trunc_normal(
                    rng(), np.empty((n_l, s.d_conv, 1, s.conv_dim),
                                    np.float32), 1.0 / math.sqrt(s.d_conv)),
                "conv_b": np.zeros((n_l, s.conv_dim), np.float32),
                "A_log": np.log(1.0 + rng().uniform(size=(n_l, h)) * 15.0)
                .astype(np.float32),
                "D": ones(n_l, h),
                "dt_bias": (dt + np.log(-np.expm1(-dt))).astype(np.float32),
                "norm": {"scale": ones(n_l, di)},
                "out_proj": dense((n_l, di, d), di),
            },
        },
        "final_norm": {"scale": ones(d)},
    }
    if cfg.attn_every:
        H, K, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        params["shared"] = {
            "norm1": {"scale": ones(d)},
            "attn": {"wq": dense((d, H, Dh), d), "wk": dense((d, K, Dh), d),
                     "wv": dense((d, K, Dh), d),
                     "wo": dense((H, Dh, d), H * Dh)},
            "norm2": {"scale": ones(d)},
            "mlp": {"wi": dense((d, F), d), "wo": dense((F, d), F),
                    "wg": dense((d, F), d)},
        }
    return params


def params_checksum(tree: dict) -> str:
    """sha256 over a numpy parameter tree: each leaf's path, shape and
    float32 bytes, in sorted path order."""
    digest = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
            return
        a = np.ascontiguousarray(node, dtype="<f4")
        digest.update(f"{path}:{a.shape}".encode())
        digest.update(memoryview(a).cast("B"))

    walk(tree, "")
    return digest.hexdigest()


def lm_params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """The reference's `init` parameter tree (`mamba_lm`, `transformer`
    or `whisper`), as numpy arrays, as the port's parameter tree on
    `device`: leaves in `cfg.param_dtype` except A_log, D, dt_bias and
    the MoE router, which stay float32 as in the reference."""
    dev = _device.resolve(device)

    def put(node, name):
        if isinstance(node, dict):
            return {k: put(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a, np.float32)
        dtype = torch.float32 if name in F32_LEAVES else cfg.param_dtype
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    return put(tree, "")
