"""K9 tiled_matmul, K10/K11 the membench copies and K12 vector_add: each
wrapper's plain version (what it takes on the CPU) against the JAX
package's Pallas kernel in interpret mode, as the JAX package's own tests
run it on the CPU, with the tolerances of torch_parity.TOL (the copies and
the f32 add bit-equal); and the raises where the TPU kernel asserts. The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.hello_pallas import \
    vector_add as j_add
from physics_llm_inference_tpu.kernels.int8_matmul import \
    quantize_weights_int8 as j_quantize_w
from physics_llm_inference_tpu.kernels.matmul import tiled_matmul as j_mm
from physics_llm_inference_tpu.kernels.membench import \
    _stream_copy as j_stream
from physics_llm_inference_tpu.kernels.membench import \
    _strided_copy as j_strided
from physics_llm_inference_tpu_torch.kernels import hello_pallas as t_hello
from physics_llm_inference_tpu_torch.kernels import int8_matmul as t_i8
from physics_llm_inference_tpu_torch.kernels import matmul as t_mm
from physics_llm_inference_tpu_torch.kernels import membench as t_mem
from torch_parity import TOL, assert_close, t2n

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(shape, dtype, seed):
    """The same values as a torch tensor and a jax array of `dtype`."""
    a = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return (torch.from_numpy(a).to(_TORCH[dtype]),
            jnp.asarray(a).astype(_JAX[dtype]))


# ---- K9 tiled_matmul ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(512, 1024, 768), (128, 128, 128),
                                   (256, 2048, 256)])
def test_tiled_matmul_plain_matches_pallas(m, k, n, dtype):
    """The JAX test shapes: several blocks on every axis, one block, and
    K = 2048 (4 K-blocks carried in the accumulator)."""
    ta, ja = _pair((m, k), dtype, 1)
    tb, jb = _pair((k, n), dtype, 2)
    before = t_mm.launches
    got = t_mm.tiled_matmul(ta, tb)
    assert got.dtype == _TORCH[dtype] and t_mm.launches == before
    want = j_mm(ja, jb, interpret=True)
    assert_close(t2n(got), want, dtype)


def test_tiled_matmul_out_dtype_matches_pallas():
    ta, ja = _pair((256, 512), "bfloat16", 3)
    tb, jb = _pair((512, 256), "bfloat16", 4)
    got = t_mm.tiled_matmul(ta, tb, out_dtype=torch.float32)
    want = j_mm(ja, jb, out_dtype=jnp.float32, interpret=True)
    assert got.dtype == torch.float32
    # bf16 products are exact in f32: only the order of the f32 sums differs
    assert_close(t2n(got), want, "float32")


@pytest.mark.parametrize("a_shape,b_shape,kw", [
    ((100, 128), (128, 128), dict(block_m=64)),   # the JAX test's case
    ((128, 96), (96, 128), dict(block_k=64)),
    ((128, 128), (128, 200), dict(block_n=128)),
    ((128, 64), (32, 128), {}),                   # inner dims differ
])
def test_tiled_matmul_raises_where_pallas_asserts(a_shape, b_shape, kw):
    ta, ja = _pair(a_shape, "float32", 5)
    tb, jb = _pair(b_shape, "float32", 6)
    with pytest.raises(AssertionError):
        j_mm(ja, jb, interpret=True, **kw)
    with pytest.raises(ValueError):
        t_mm.tiled_matmul(ta, tb, **kw)


def test_tiled_matmul_takes_what_the_check_lets_through():
    """100 rows pass the TPU check at the default block (clamped to 100);
    the port computes them."""
    ta, ja = _pair((100, 128), "float32", 7)
    tb, jb = _pair((128, 128), "float32", 8)
    assert_close(t2n(t_mm.tiled_matmul(ta, tb)),
                 j_mm(ja, jb, interpret=True), "float32")


def test_tiled_matmul_mixed_dtypes_raise():
    a = torch.zeros((128, 128))
    with pytest.raises(TypeError):
        t_mm.tiled_matmul(a, a.bfloat16())


# ---- K10 / K11 the membench copies ------------------------------------------

@pytest.mark.parametrize("rows,block_rows", [(4096, 2048), (768, 256)])
def test_stream_copy_plain_matches_pallas(rows, block_rows):
    tx, jx = _pair((rows, 128), "float32", 9)
    before = t_mem.stream_launches
    got = t_mem._stream_copy(tx, block_rows=block_rows)
    assert t_mem.stream_launches == before
    want = j_stream(jx, block_rows=block_rows, interpret=True)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    assert got.data_ptr() != tx.data_ptr()


def test_stream_copy_raises_on_a_partial_block():
    """The TPU kernel leaves the rows past the last whole block unwritten;
    the port refuses such an N."""
    with pytest.raises(ValueError):
        t_mem._stream_copy(torch.zeros((3000, 128)), block_rows=2048)


@pytest.mark.parametrize("rows,block_rows,stride", [
    (512, 8, 32),       # the default: 2 blocks
    (1000, 8, 4),       # rows past the last whole stride are ignored
    (2048, 16, 8),
])
def test_strided_copy_plain_matches_pallas(rows, block_rows, stride):
    tx, jx = _pair((rows, 128), "float32", 10)
    before = t_mem.strided_launches
    got = t_mem._strided_copy(tx, block_rows=block_rows, stride=stride)
    assert t_mem.strided_launches == before
    want = j_strided(jx, block_rows=block_rows, stride=stride, interpret=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


# ---- K12 vector_add ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block_rows", [((512, 128), 256),
                                              ((300, 128), 100),
                                              ((64, 256), 256)])
def test_vector_add_plain_matches_pallas(shape, block_rows, dtype):
    ta, ja = _pair(shape, dtype, 11)
    tb, jb = _pair(shape, dtype, 12)
    before = t_hello.launches
    got = t_hello.vector_add(ta, tb, block_rows=block_rows)
    assert got.dtype == _TORCH[dtype] and t_hello.launches == before
    want = j_add(ja, jb, block_rows=block_rows, interpret=True)
    # one add, rounded once to the dtype on both sides
    np.testing.assert_array_equal(t2n(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("a_shape,b_shape", [
    ((300, 128), (300, 128)),    # 300 rows, blocks of 256
    ((256, 128), (128, 128)),    # shapes differ
    ((256,), (256,)),            # not 2-D
])
def test_vector_add_raises_where_pallas_asserts(a_shape, b_shape):
    ta, ja = _pair(a_shape, "float32", 13)
    tb, jb = _pair(b_shape, "float32", 14)
    with pytest.raises(AssertionError):
        j_add(ja, jb, interpret=True)
    with pytest.raises(ValueError):
        t_hello.vector_add(ta, tb)


# ---- quantize_weights_int8 (bench_gemv's weights) ----------------------------

def test_quantize_weights_int8_matches_jax():
    tw, jw = _pair((256, 384), "float32", 15)
    tq, ts = t_i8.quantize_weights_int8(tw)
    jq, js = j_quantize_w(jw)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (1, 384)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                               **TOL["float32"])
