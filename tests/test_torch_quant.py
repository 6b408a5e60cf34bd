"""The port's quantization (plain kernel versions and ``core.compression``)
against the reference's.

Inputs are made with numpy and handed to both packages.  Every case is held
against the reference's jnp oracles (``kernels/ref.py``); the cases at the
reference's own test block of 256 also against its Pallas kernels, run in
interpret mode as tests/test_kernels.py runs them (interpret mode compiles
per shape, which is what bounds this file's run time).
Tolerances, as the reference states its contract (``kernels/quant.py``):
q, scales and deq of the EF step are bit-equal to the oracle and the
residual is within 1 ulp of deq: the Pallas kernel may contract
``t - q*scale`` into an FMA, which skips the rounding of the product (at
most half an ulp of deq); the oracle and the port round the product first,
so they agree bit for bit.  ``quantize_blocks``'s scales are within rtol 1e-6 of the Pallas
kernel's, whose compiler may turn ``/ qmax`` into a reciprocal multiply;
they are bit-equal to the eager oracle's true division.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops, quant, ref

SIZES = (1, 255, 1024, 5000)
BLOCKS = (64, 256, 1024)
PALLAS_BLOCK = 256


def _grad_and_residual(n: int, seed: int = 0):
    rng = np.random.default_rng([n, seed])
    g = rng.normal(size=n).astype(np.float32)
    e = (rng.normal(size=n) * 0.01).astype(np.float32)
    return g, e


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_residual_within_ulp_of_deq(r, want_r, want_deq):
    r, want_r, want_deq = (np.asarray(x, np.float32) for x in (r, want_r, want_deq))
    assert (np.abs(r - want_r) <= np.spacing(np.abs(want_deq))).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("block", BLOCKS)
def test_ef_quantize_bucketize_matches_reference(n, bits, block):
    g, e = _grad_and_residual(n)
    q, s, deq, r, n_out = quant.ef_quantize_bucketize(_t(g), _t(e), block=block, bits=bits)
    assert n_out == n and q.dtype == torch.int8 and q.shape[0] % block == 0
    want_oracle = jref.ef_quantize_bucketize_ref(jnp.asarray(g), jnp.asarray(e),
                                                 block=block, bits=bits)
    wants = [want_oracle]
    if block == PALLAS_BLOCK:
        wants.append(jops.ef_quantize_bucketize(jnp.asarray(g), jnp.asarray(e),
                                                block=block, bits=bits))
    for want in wants:
        wq, ws, wdeq, wr = (np.asarray(x) for x in want[:4])
        np.testing.assert_array_equal(q.numpy(), wq)
        np.testing.assert_array_equal(s.numpy(), ws)
        np.testing.assert_array_equal(deq.numpy(), wdeq)
        _assert_residual_within_ulp_of_deq(r.numpy(), wr, wdeq)
    np.testing.assert_array_equal(r.numpy(), np.asarray(want_oracle[3]))
    assert int(q.abs().max()) <= 2 ** (bits - 1) - 1


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("block", BLOCKS)
def test_quantize_blocks_matches_reference(n, bits, block):
    x, _ = _grad_and_residual(n, seed=1)
    q, s, n_out = quant.quantize_blocks(_t(x), block=block, bits=bits)
    assert n_out == n
    oq, os_, _ = jref.quantize_blocks_ref(jnp.asarray(x), block=block, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(oq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(os_))
    if block != PALLAS_BLOCK:
        return
    pq, ps, _ = jops.quantize_blocks(jnp.asarray(x), block=block, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("acc_dtype", (torch.float32, torch.bfloat16))
def test_dequant_add_round_trip(n, block, acc_dtype):
    """acc + dequant(quantize(x)) recovers x within max|x|/127 (the
    reference's bound, tests/test_kernels.py), and equals the reference's
    fused kernel; bf16 output rounds once more (2^-8 relative)."""
    x, a = _grad_and_residual(n, seed=2)
    q, s, _ = quant.quantize_blocks(_t(x), block=block)
    acc = torch.from_numpy(np.pad(a, (0, q.shape[0] - n))).to(acc_dtype)
    got = quant.dequant_add(q, s, acc, block=block)
    assert got.dtype == acc_dtype and got.shape == acc.shape
    bound = float(np.abs(x).max()) / 127 + 1e-6
    rounding = 2 ** -8 * float(np.abs(x + a).max()) if acc_dtype == torch.bfloat16 else 0.0
    err = np.abs(got[:n].float().numpy() - (x + acc[:n].float().numpy())).max()
    assert err <= bound + rounding
    if acc_dtype != torch.float32:
        return
    jq, js, jacc = (jnp.asarray(t.numpy()) for t in (q, s, acc))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.dequant_add_ref(jq, js, jacc, block=block)))
    if block == PALLAS_BLOCK:
        want = jops.dequant_add(jq, js, jacc, block=block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", (1, 255, 5000))
@pytest.mark.parametrize("bits", (8, 4, 32))
@pytest.mark.parametrize("fused", (False, True))
def test_ef_compress_blocks_matches_reference(n, bits, fused):
    g, e = _grad_and_residual(n, seed=3)
    deq, r = tcomp.ef_compress_blocks(_t(g), _t(e), bits=bits, block=256, fused=fused)
    wdeq, wr = jcomp.ef_compress_blocks(jnp.asarray(g), jnp.asarray(e), bits=bits, block=256,
                                        fused=fused)
    assert deq.shape == (n,) and r.shape == (n,)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(wdeq))
    _assert_residual_within_ulp_of_deq(r.numpy(), wr, wdeq)


def test_fused_and_tensor_paths_agree_bitwise():
    g, e = _grad_and_residual(3000, seed=4)
    a = tcomp.ef_compress_blocks(_t(g), _t(e), bits=8, block=128, fused=True)
    b = tcomp.ef_compress_blocks(_t(g), _t(e), bits=8, block=128, fused=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_ef_invariant_and_zero_block_floor():
    """deq + new residual == grad + old residual (to 1 ulp of the sum); an all-zero
    block takes the 1e-30 scale floor and quantizes to zeros."""
    g, e = _grad_and_residual(2048, seed=5)
    g[:1024] = 0.0
    e[:1024] = 0.0
    q, s, deq, r, _ = quant.ef_quantize_bucketize(_t(g), _t(e), block=1024)
    assert float(s[0]) == float(np.float32(1e-30) * np.float32(1 / 127))
    assert not q[:1024].any() and not deq[:1024].any()
    np.testing.assert_array_max_ulp((deq + r).numpy(), g + e, maxulp=1)


@pytest.mark.parametrize("bits", (8, 4))
def test_per_tensor_quantize_matches_reference(bits):
    x, g = _grad_and_residual(777, seed=6)
    c = tcomp.quantize(_t(x), bits)
    w = jcomp.quantize(jnp.asarray(x), bits)
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(w.q))
    assert float(c.scale) == float(w.scale)
    np.testing.assert_array_equal(tcomp.dequantize(c).numpy(), np.asarray(jcomp.dequantize(w)))
    (tc_, tr), (jc, jr) = tcomp.ef_compress(_t(g), _t(x), bits), jcomp.ef_compress(
        jnp.asarray(g), jnp.asarray(x), bits)
    np.testing.assert_array_equal(tc_.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    empty = tcomp.quantize(torch.zeros(0), bits)
    assert empty.q.numel() == 0 and float(empty.scale) == 1.0


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="1-D"):
        quant.ef_quantize_bucketize(x.reshape(2, 4), x.reshape(2, 4))
    with pytest.raises(ValueError, match="bits"):
        quant.quantize_blocks(x, bits=16)
    with pytest.raises(ValueError, match="block"):
        quant.dequant_add(torch.zeros(8, dtype=torch.int8), torch.ones(3), x, block=4)


def test_kernels_registered_with_counters():
    counts = ops.launch_counts()
    assert {"ef_quantize_bucketize", "quantize_blocks", "dequant_add"} <= set(counts)
    before = dict(counts)
    quant.ef_quantize_bucketize(torch.ones(10), torch.zeros(10))
    assert ops.launch_counts() == before   # the CPU path launches nothing
    assert ref.ef_quantize_bucketize_ref is quant.ef_quantize_bucketize_ref
