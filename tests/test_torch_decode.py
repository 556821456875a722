"""The port's second plain decode attention, ``decode_attention_split_plain``
(the Pallas kernel's own order: a partial softmax per split, then the
online-softmax combine), against the JAX package's Pallas kernel in
interpret mode and ``repro.kernels.ref.decode_attention_ref``, and against
the port's own ``decode_attention_plain`` on a decode step of the model.

``chip_smoke.py`` runs it as the ``plain_split`` path of ``serve_check``,
whose distance from the plain path is that check's noise floor; here it is
held to be the same function.  Inputs come from numpy seeds; every case is
f32 at rtol/atol 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.configs import smoke_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model

F32 = dict(rtol=1e-5, atol=1e-5)
B, H, HKV, DH = 5, 6, 2, 16


def _inputs(seed, Smax):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 1, H, DH).astype(np.float32)
    kc = rs.randn(B, Smax, HKV, DH).astype(np.float32)
    vc = rs.randn(B, Smax, HKV, DH).astype(np.float32)
    return q, kc, vc


def _split_plain(q, kc, vc, end, start, split):
    t = [torch.from_numpy(a) for a in (q, kc, vc, end, start)]
    return da.decode_attention_split_plain(*t, split=split).numpy()


# (start, end) per row; the split is 16 and Smax 64 for the Pallas kernel
WINDOWS = {
    "ends_on_split_boundary": ([0, 0, 16, 5, 0], [32, 16, 48, 64, 64]),
    "starts_mid_split": ([7, 21, 3, 40, 50], [30, 64, 17, 41, 63]),
    "empty_window": ([0, 9, 30, 0, 12], [0, 9, 20, 64, 40]),
    "one_row": ([0, 15, 16, 63, 31], [1, 16, 17, 64, 32]),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_split_plain_matches_pallas_and_ref(case):
    """Windows against a split of 16 over Smax = 64 (which the Pallas
    wrapper's ``_fit_split`` keeps): the split plain version equals the
    Pallas kernel (interpret mode, the same split) and the dense reference;
    an empty window gives finite zeros."""
    q, kc, vc = _inputs(11, 64)
    start, end = (np.asarray(w, np.int32) for w in WINDOWS[case])
    out = _split_plain(q, kc, vc, end, start, 16)
    pal = np.asarray(decode_attention_pallas(q, kc, vc, end, start, split_k=16,
                                             interpret=True))
    ref = np.asarray(jref.decode_attention_ref(q, kc, vc, end, start))
    np.testing.assert_allclose(out, pal, **F32)
    np.testing.assert_allclose(out, ref, **F32)
    assert np.all(np.isfinite(out))
    for row in np.flatnonzero(end <= start):
        assert np.all(out[row] == 0.0)


@pytest.mark.parametrize("Smax, split", [(40, 16), (1000, 128), (70, 128)])
def test_split_plain_smax_not_a_multiple_of_the_split(Smax, split):
    """The port masks the last split (which the Pallas wrapper cannot
    take): against the dense reference, with windows that reach into it."""
    q, kc, vc = _inputs(12, Smax)
    end = np.asarray([Smax, Smax - 1, Smax // 2, 3, Smax], np.int32)
    start = np.asarray([0, Smax // 3, 1, 3, Smax - 2], np.int32)
    out = _split_plain(q, kc, vc, end, start, split)
    ref = np.asarray(jref.decode_attention_ref(q, kc, vc, end, start))
    np.testing.assert_allclose(out, ref, **F32)
    assert np.all(out[3] == 0.0)


def test_split_plain_is_the_plain_version_on_a_decode_step():
    """One decode step of the smoke llama config (f32 weights and caches,
    rows of different prompt lengths, Smax = 40, three splits of 16 with the
    last masked): logits through ``decode_attention_split_plain`` equal the
    ones through ``decode_attention_plain`` -- the two plain paths of
    ``serve_check`` are one function summed in two orders."""
    cfg = smoke_config("llama3.2-3b")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params = _tree_float(params)
    rs = np.random.RandomState(5)
    rows, max_len, Lp = 4, 40, 24
    lengths = torch.tensor([24, 7, 16, 1], dtype=torch.int32)
    tokens = torch.from_numpy(rs.randint(1, cfg.vocab_size, (rows, Lp)).astype(np.int32))
    nxt = torch.from_numpy(rs.randint(1, cfg.vocab_size, (rows, 1)).astype(np.int32))

    def step():
        st = model.init_decode_state(rows, max_len, cache_dtype=torch.float32)
        _, st = model.prefill(params, {"tokens": tokens}, st, lengths=lengths)
        logits, st = model.decode_step(params, st, nxt)
        logits2, _ = model.decode_step(params, st, nxt)
        return torch.cat([logits, logits2], 1).numpy()

    want = step()
    plain = da.decode_attention_plain
    da.decode_attention_plain = functools.partial(da.decode_attention_split_plain, split=16)
    try:
        got = step()
    finally:
        da.decode_attention_plain = plain
    np.testing.assert_allclose(got, want, **F32)
    assert ops.launch_counts()["decode_attention"] == 0


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()
