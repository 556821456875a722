"""VeRA [Kopiczko et al., 2024] — shared frozen A/B + per-task vectors.

y += diag(b) . B . diag(d) . A . x : the projections A / B are frozen,
shared by every tenant of the kind (no task axis) and rebuilt by
``post_init`` from a site-keyed generator; only the per-task vectors ``d``
(init 0.1) and ``b`` (init zero) train.

The generator is the JAX package's: row i of a matrix is
``jax.random.normal(fold_in(PRNGKey(crc32(tag)), i), (row_len,))``, which
:func:`_det_rows` computes in numpy — threefry-2x32 (``PRNGKey``,
``fold_in``, the partitionable bit layout), the uniform draw on
[nextafter(-1, 0), 1) and sqrt(2) erfinv(u) by Giles' single-precision
polynomial, as XLA lowers ``erf_inv`` (up to its log1p: see
:func:`_erfinv_f32`).  So a VeRA tenant checkpointed by one package
warm-starts in the other against the same bf16 projections.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import ParamSpec
from repro_torch.peft.methods.base import ApplyContext, PEFTMethod

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Giles' erfinv coefficients for w < 5 and w >= 5 (XLA's ErfInv32)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds) on uint32 arrays."""
    u32 = np.uint32
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """erfinv of f32 ``x`` in f32, the polynomial's Horner steps fused
    multiply-adds as XLA's CPU backend contracts them (each product of two
    f32 values is exact in f64, so one f64 add and one rounding emulate the
    fused step).  ``np.log1p`` stands in for XLA's own log1p, which is not
    ported: 1.26% of the generator's values come up to 3 f32 units in the
    last place away from JAX's, and none after the cast to bf16."""
    f32, f64 = np.float32, np.float64
    w = -np.log1p(x * -x)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(cs), f32(cl))
        p = (c.astype(f64) + p.astype(f64) * w.astype(f64)).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)


def _det_rows(tag: str, n_rows: int, row_len: int) -> np.ndarray:
    """[n_rows, row_len] f32 standard normals, row i a pure function of
    (tag, i): ``jax.random.normal(fold_in(PRNGKey(crc32(tag) & 0x7FFFFFFF),
    i), (row_len,))``."""
    u32, f32 = np.uint32, np.float32
    with np.errstate(over="ignore"):
        seed = zlib.crc32(tag.encode()) & 0x7FFFFFFF
        # fold_in(key, i) = threefry(key, [0, i]); PRNGKey(seed) = [0, seed]
        k0, k1 = _threefry2x32(u32(0), u32(seed), np.zeros(n_rows, u32),
                               np.arange(n_rows, dtype=u32))
        # 32 random bits per element: counts (0, j), the two words xor'd
        j = np.arange(row_len, dtype=u32)[None, :]
        b0, b1 = _threefry2x32(k0[:, None], k1[:, None], np.zeros_like(j), j)
    bits = b0 ^ b1
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    floats = ((bits >> u32(9)) | u32(0x3F800000)).view(f32) - f32(1.0)
    u = np.maximum(lo, floats * (f32(1.0) - lo) + lo)
    return f32(np.sqrt(2)) * _erfinv_f32(u)


class VeRA(PEFTMethod):
    name = "vera"
    category = "reparameterized"
    shared_params = frozenset({"A", "B"})

    def param_specs(self, rank, d_in, d_out, capacity) -> Dict[str, ParamSpec]:
        t = (capacity,)
        return {
            # shared frozen projections (no task axis; post_init overwrites
            # them with the site-keyed values)
            "A": ParamSpec((d_in, rank), scale=0.02),
            "B": ParamSpec((rank, d_out), scale=0.02),
            # per-task trainable scaling vectors
            "d": ParamSpec(t + (rank,), init="const", scale=0.1),
            "b": ParamSpec(t + (d_out,), init="zeros"),
        }

    def post_init(self, params, site, d_in, d_out):
        rank = int(params["A"].shape[-1])
        a = _det_rows(f"vera:A:{site}:{d_in}", rank, d_in).T * np.float32(0.02)  # [d_in, r]
        b = _det_rows(f"vera:B:{site}:{d_out}", rank, d_out) * np.float32(0.02)  # [r, d_out]
        out = dict(params)
        for name, m in (("A", a), ("B", b)):
            leaf = params[name]
            out[name] = torch.from_numpy(np.ascontiguousarray(m)).to(
                device=leaf.device, dtype=leaf.dtype).expand(leaf.shape).contiguous()
        return out

    def param_count(self, rank, d_in, d_out) -> int:
        # per task: the scaling vectors; the shared A / B are charged once
        # per kind stack (shared_param_count)
        return rank + d_out

    def shared_param_count(self, rank, d_in, d_out) -> int:
        return d_in * rank + rank * d_out

    def flops_per_token(self, rank, d_in, d_out) -> float:
        return 2.0 * rank * (d_in + d_out) + rank + d_out

    def apply(self, p, x, base_out, ctx: ApplyContext
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        t = ctx.rows
        # A / B are frozen: detached, so no backward work is spent on them
        a = p["A"].detach().float()
        bm = p["B"].detach().float()
        h = torch.einsum("bsi,ir->bsr", x.float(), a)
        h = h * p["d"][t].float()[:, None, :]     # diag(d)
        y = torch.einsum("bsr,ro->bso", h, bm)
        y = y * p["b"][t].float()[:, None, :]     # diag(b)
        return y * ctx.gate[:, None, None], None
