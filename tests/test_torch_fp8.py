"""The fp8 (e4m3fn) codec of the port against the JAX package, BIT FOR BIT
(zero tolerance; e4m3 codes compared as their bytes, floats as their bit
patterns).

The JAX side runs its Pallas kernels in interpret mode
(``quantize_fp8(interpret=True)``, ``PallasFp8Compressor(impl=
"interpret")``, the TPU kernel path) and its reference codec jitted, as
its engine runs it; the port's side runs the kernels' plain versions (CPU
tensors never launch). "The JAX package" is the program XLA compiles from
it, which differs from the source in three ways that these tests pin:

- the scale is ``absmax * f32(1/448)`` (bits ``0x3b124925``), the
  product XLA compiles ``absmax / 448`` into; the eager quotient differs
  in the last bit on most rows;
- the f32 -> e4m3fn cast sends NaN, inf and ``|y| > 464`` to the NaN code
  of y's sign, where PyTorch's own cast saturates at ±448;
- f32 subnormals count as zeros wherever they enter the arithmetic and
  are flushed wherever they come out of it: a row of subnormals gets
  scale 0 and zero codes, a row whose scale would be subnormal gets scale
  0, a subnormal element beside a tiny normal absmax codes as zero, and a
  subnormal product ``q * scale`` decodes as zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.compress import Fp8Compressor as JaxFp8
from consensusml_tpu.compress import PallasFp8Compressor as JaxPallasFp8
from consensusml_tpu.compress import kernels as jk
from consensusml_tpu_torch.compress import (
    FP8_E4M3_MAX,
    Fp8Compressor,
    Fp8Payload,
    PallasFp8Compressor,
    dequantize_fp8,
    fused_bucket_codec,
    fused_pack_quantize,
    quantize_fp8,
)
from consensusml_tpu_torch.compress.kernels import dequantize_fp8_plain, quantize_fp8_plain
from consensusml_tpu_torch.compress.reference import from_e4m3, to_e4m3

F32_MIN = np.float32(2.0**-126)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.dtype == torch.float8_e4m3fn else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def _bits(a):
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _rows(seed, rows, chunk):
    """Rows across magnitudes, with the fp8 quantizer's hazards in front."""
    rng = np.random.default_rng(seed)
    mags = 2.0 ** rng.integers(-60, 60, size=(rows, 1))
    x = (rng.normal(size=(rows, chunk)) * mags).astype(np.float32)
    col = np.arange(chunk)
    x[0] = 0.0
    x[1] = np.where(col % 2, -0.0, 0.0)
    x[2, 5] = np.nan
    x[3, 9] = np.inf
    x[4, 1] = -np.inf
    x[5] = np.float32(1e-39) * np.where(col % 3, 1, -1)  # subnormals only: scale 0, codes 0 (or -0)
    x[6] *= np.float32(5e-36) / np.abs(x[6]).max()  # absmax 5e-36: absmax * (1/448) is subnormal
    # a tiny normal absmax (scale just above the smallest normal) beside
    # subnormal elements, which code as nonzero unless read as zeros
    x[7] = np.float32(0.9) * F32_MIN * np.where(col % 2, 1, -1)
    x[7, 0] = np.float32(448 * 1.5) * F32_MIN
    return x


@pytest.mark.parametrize("rows,chunk", [(40, 128), (11, 256), (33, 512), (9, 1024)])
def test_quantize_dequantize_fp8_bit_equal(rows, chunk):
    x = _rows(rows + chunk, rows, chunk)
    wq, ws = jk.quantize_fp8(jnp.asarray(x), interpret=True)
    before = (quantize_fp8.launches, dequantize_fp8.launches)
    q, s = quantize_fp8(torch.from_numpy(x))
    assert q.dtype == torch.float8_e4m3fn and q.shape == (rows, chunk) and s.shape == (rows,)
    _eq(q, wq, "codes")
    _eq(s, ws, "scales")
    d = dequantize_fp8(q, s)
    _eq(d, jk.dequantize_fp8(wq, ws, interpret=True), "dequantize")
    assert (quantize_fp8.launches, dequantize_fp8.launches) == before  # CPU tensors never launch
    # the hazards, read off the port's payload
    codes = q.view(torch.uint8)
    assert s[0] == 0 and torch.isnan(s[2]) and torch.isinf(s[3]) and torch.isinf(s[4])
    assert not codes[0].any() and not (codes[1] & 0x7F).any()
    assert codes[2, 5] == 0x7F and codes[3, 9] in (0x7F, 0xFF)  # NaN codes: NaN, inf * 0
    assert s[5] == 0 and not (codes[5] & 0x7F).any() and s[6] == 0 and not (codes[6] & 0x7F).any()
    assert s[7] > 0 and (codes[7, 1:] & 0x7F).eq(0).all() and codes[7, 0] == 0x7E  # absmax codes as 448


def test_e4m3_cast_matches_the_reference():
    """Every f32 -> e4m3fn the codec can meet, against ``jnp`` under jit:
    a sweep of magnitudes over the format's range and past it, its ties
    (half a code apart, which round to the even code), subnormal codes,
    signed zeros, NaN and inf. And every code back to f32."""
    rng = np.random.default_rng(0)
    sweep = (rng.uniform(-1, 1, 50_000) * 2.0 ** rng.integers(-14, 11, 50_000)).astype(np.float32)
    codes = np.arange(256, dtype=np.uint8)
    grid = np.asarray(jnp.asarray(codes).view(jnp.float8_e4m3fn).astype(jnp.float32))
    finite = np.sort(grid[np.isfinite(grid)])
    ties = ((finite[1:].astype(np.float64) + finite[:-1]) / 2).astype(np.float32)  # exact in f32
    edges = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 448, 464, -464, 464.01, 479, 480, 1e6,
                      2.0**-9, 2.0**-10, -(2.0**-10), 3 * 2.0**-11, 2.0**-6, 1e-39, -1e-39], np.float32)
    y = np.concatenate([sweep, ties, -ties, edges])
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.float8_e4m3fn))(jnp.asarray(y))).view(np.uint8)
    got = to_e4m3(torch.from_numpy(y)).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    # PyTorch's own cast saturates where the reference gives NaN (so the
    # port does not use it bare)
    naive = torch.from_numpy(y).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (naive != want).any() and ((naive != want) <= (np.abs(y) > 464)).all()
    back = from_e4m3(torch.from_numpy(codes).view(torch.float8_e4m3fn))
    _eq(back, grid, "decode of every code")


def test_scale_is_the_compiled_product_not_the_eager_quotient():
    """The eager reference divides ``absmax / 448``; jitted (and in its
    kernel) XLA multiplies by f32(1/448). They differ in the last bit on
    most rows; the port matches the kernel path on every row."""
    x = np.random.default_rng(16).normal(size=(64, 512)).astype(np.float32)
    _, kernel_scales = jk.quantize_fp8(jnp.asarray(x), interpret=True)
    kernel_scales = np.asarray(kernel_scales)
    assert np.float32(1 / FP8_E4M3_MAX).view(np.uint32) == 0x3B124925
    eager = JaxFp8(chunk=512).compress(jnp.asarray(x.reshape(-1)))
    jitted = jax.jit(JaxFp8(chunk=512).compress)(jnp.asarray(x.reshape(-1)))
    assert (np.asarray(eager.scales) != kernel_scales).sum() > 8
    _eq(jitted.scales, kernel_scales, "jitted")
    _, s = quantize_fp8_plain(torch.from_numpy(x))
    _eq(s, kernel_scales, "port")
    _eq(Fp8Compressor(chunk=512).compress(torch.from_numpy(x.reshape(-1))).scales, kernel_scales, "port codec")


def test_subnormals_are_flushed_as_in_the_reference():
    """The rows of ``_rows`` that carry subnormals: the port equals the
    reference, and the quantizer written without the flushes (PyTorch
    keeps subnormals) does not, in the codes and in the decode."""
    x = _rows(3, 8, 128)[5:]
    wq, ws = jk.quantize_fp8(jnp.asarray(x), interpret=True)
    q, s = quantize_fp8_plain(torch.from_numpy(x))
    _eq(q, wq, "codes")
    _eq(s, ws, "scales")
    xt = torch.from_numpy(x)
    raw_s = xt.abs().amax(1) * torch.tensor(np.float32(1 / 448))
    inv = torch.where(raw_s > 0, 1 / torch.where(raw_s > 0, raw_s, 1), 0)
    naive = (xt * inv[:, None]).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (naive != _np(wq)).any() and (_bits(raw_s.numpy()) != _bits(np.asarray(ws))).any()
    # a small code times a small scale is a subnormal product: decoded as 0
    codes = torch.full((1, 128), 2.0**-9).to(torch.float8_e4m3fn)  # the smallest code
    scales = torch.tensor([np.float32(2.0**-120)])
    d = dequantize_fp8_plain(codes, scales)
    _eq(d, jk.dequantize_fp8(jnp.asarray(_np(codes)).view(jnp.float8_e4m3fn), jnp.asarray(scales.numpy()),
                             interpret=True))
    assert not d.any() and (codes.float() * scales).abs().max() > 0


@pytest.mark.parametrize("shape", [(5,), (300,), (4096,), (3, 70), (7, 300)])
def test_pallas_fp8_codec_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[:2] = 0.0
    tc, jc = PallasFp8Compressor(chunk=512), JaxPallasFp8(chunk=512, impl="interpret")
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert isinstance(tp, Fp8Payload) and tp.chunk == jp.chunk and tp.data.dtype == torch.float8_e4m3fn
    _eq(tp.data, jp.data, "data")
    _eq(tp.scales, jp.scales, "scales")
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    # the kernel path's layout (chunk never below 128)
    assert tc.wire_bytes(shape) == jc.wire_bytes(shape, jnp.float32)
    assert tc.bucket_alignment() == 512 and tc.fused_wire() == "fp8"


@pytest.mark.parametrize("chunk,n", [(256, 1000), (7, 100), (9, 4), (512, 5)])
def test_reference_fp8_codec_bit_equal(chunk, n):
    """The semantics oracle against the jitted reference: the chunk clamped
    to the tensor, any chunk width."""
    x = np.random.default_rng(chunk + n).normal(size=(n,)).astype(np.float32) * 1e3
    tc, jc = Fp8Compressor(chunk=chunk), JaxFp8(chunk=chunk)
    assert tc.bucket_alignment() == jc.bucket_alignment() == chunk
    tp, jp = tc.compress(torch.from_numpy(x)), jax.jit(jc.compress)(jnp.asarray(x))
    assert tp.chunk == jp.chunk
    _eq(tp.data, jp.data, "data")
    _eq(tp.scales, jp.scales, "scales")
    _eq(tc.decompress(tp), jax.jit(jc.decompress)(jp), "decompress")
    assert tc.wire_bytes((n,)) == jc.wire_bytes((n,), jnp.float32)


def test_fused_fp8_codes_equal_the_standalone_quantize():
    """The reference's wire contract (``compress/kernels.py:265-266``): the
    fused encode ships the bytes ``quantize_fp8`` makes of ``x - xhat``,
    and the fused codec the standalone codec's payload."""
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(24, 256)) * 3).astype(np.float32)
    xhat = (x + rng.normal(scale=0.2, size=x.shape)).astype(np.float32)
    xt, ht = torch.from_numpy(x), torch.from_numpy(xhat)
    data, scales, _hat = fused_pack_quantize(xt, ht, fmt="fp8")
    q, s = quantize_fp8(xt - ht)
    _eq(data, q, "codes")
    _eq(scales, s, "scales")
    codec = fused_bucket_codec(PallasFp8Compressor(chunk=256))
    payload, _ = codec.encode(xt.reshape(-1), ht.reshape(-1))
    want = PallasFp8Compressor(chunk=256).compress((xt - ht).reshape(-1))
    _eq(payload.data, want.data, "codec data")
    _eq(payload.scales, want.scales, "codec scales")
