"""
The port's flash-attention forward (gordo_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel, run as tests/test_seq_models.py
runs it on the CPU (interpret mode), and against dense attention.

Head_dims off the kernel widths are zero-padded to the next one on both
devices, so the CPU tests run the padding the card runs.

On CPU tensors the wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: atol 1e-5 in float32 — both sides compute the same softmax in
float32 and differ only in summation order. In float16, atol 2e-3: both
sides convert to float32, accumulate in float32 and round the output to
float16 once, so they differ by at most one float16 step of an output
under 4. In float64 (JAX under ``jax.enable_x64``), atol 1e-5: the Pallas
kernel accumulates in float32 where the plain path uses float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_tpu.models.specs_seq import dense_attention as jax_dense_attention
from gordo_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from gordo_tpu_torch import resolve_device
from gordo_tpu_torch.models.specs_seq import dense_attention
from gordo_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
FLOAT16_ATOL = 2e-3
# a ragged sequence (37: not a tile multiple) and the served model's S and
# D; then head_dims the wrapper zero-pads to the next kernel width (8 and
# 12 to 16, 48 to 64, 96 to 128, 200 to 256), as the JAX wrapper pads to a
# multiple of 128 lanes, and the widest kernel's 256
SHAPES = [(2, 37, 2, 16), (32, 64, 4, 16), (2, 37, 2, 8), (3, 29, 2, 12), (2, 37, 2, 48),
          (2, 21, 1, 96), (2, 21, 1, 200), (1, 19, 2, 256)]
# float16 and float64 cases: a kernel width of each kernel family and a
# padded head_dim
DTYPE_SHAPES = [(2, 37, 2, 16), (2, 29, 2, 64), (1, 19, 2, 200)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _lse_reference(q, k, causal):
    """log-sum-exp of the scaled scores in float64, (batch*heads, seq)."""
    batch, seq, heads, head_dim = q.shape
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    scores /= np.sqrt(head_dim)
    if causal:
        scores = np.where(np.tril(np.ones((seq, seq), dtype=bool)), scores, -np.inf)
    peak = scores.max(axis=-1, keepdims=True)
    lse = np.log(np.exp(scores - peak).sum(axis=-1)) + peak[..., 0]
    return lse.reshape(batch * heads, seq)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_matches_jax_kernel(shape, causal):
    q, k, v = _qkv(shape, seed=sum(shape) + causal)
    want = np.asarray(
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    )
    before = fa.launch_counts[fa.KERNEL]
    out, lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    assert out.shape == shape and out.dtype == torch.float32
    assert lse.shape == (shape[0] * shape[2], shape[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, causal), atol=ATOL)
    # CPU tensors take the plain version: the kernel was never launched
    assert fa.launch_counts[fa.KERNEL] == before


@pytest.mark.parametrize("shape", DTYPE_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_float16_matches_jax_kernel(shape, causal):
    """float16 in, float16 out on both sides, each accumulating in float32."""
    q, k, v = (x.astype(np.float16) for x in _qkv(shape, seed=sum(shape) + 2 + causal))
    want = np.asarray(
        jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    )
    assert want.dtype == np.float16
    out, lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want.astype(np.float32), atol=FLOAT16_ATOL)
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, causal), atol=ATOL)


@pytest.mark.parametrize("shape", DTYPE_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_float64_matches_jax_kernel(shape, causal):
    """float64 in, float64 out: JAX under x64 (float32 inside its kernel),
    the plain version in float64."""
    q, k, v = (x.astype(np.float64) for x in _qkv(shape, seed=sum(shape) + 4 + causal))
    with jax.enable_x64(True):
        want = np.asarray(
            jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
        )
    assert want.dtype == np.float64
    out, lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, causal), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_dense_attention(shape, causal):
    q, k, v = _qkv(shape, seed=7 + causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(out, dense_attention(tq, tk, tv, causal=causal).numpy(), atol=ATOL)
    want = jax_dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out, np.asarray(want), atol=ATOL)


def test_flash_reads_strided_heads():
    """The model hands the wrapper (batch, seq, heads, head_dim) views of
    one projection; strided inputs give the contiguous result."""
    q, k, v = _qkv((3, 20, 4, 16), seed=3)
    wide = torch.from_numpy(np.concatenate([q, k, v], axis=-1))  # (3, 20, 4, 48)
    tq, tk, tv = wide[..., :16], wide[..., 16:32], wide[..., 32:]
    assert not tq.is_contiguous()
    got = fa.flash_attention(tq, tk, tv, causal=True)
    want = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0)


def test_flash_rejects_mismatched_inputs():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, torch.zeros(1, 5, 2, 16), q)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, q.double(), q)


def test_flash_has_no_path_off_cpu_and_cuda():
    """Only CPU tensors take the plain version; any other device raises
    rather than falling back."""
    q = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        fa.flash_attention(q, q, q)


def test_reset_launch_counts():
    for step, name in enumerate((fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)):
        fa.launch_counts[name] += 3 + step
    fa.kernel_launches[f"{fa.KERNEL}_mma"] += 2
    fa.reset_launch_counts()
    assert fa.launch_counts == {fa.KERNEL: 0, fa.KERNEL_DQ: 0, fa.KERNEL_DKV: 0}
    assert set(fa.kernel_launches.values()) == {0}


def test_kernel_launches_name_every_kernel():
    """One counter for each CUDA kernel an entry point may launch: the
    quad, wide and tensor-core kernels of all three, the width-sliced
    forward, and the tiled dq and dk/dv on the CUDA cores and on the
    tensor cores."""
    assert sorted(fa.kernel_launches) == sorted([
        *(f"{entry}_{family}" for entry in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV)
          for family in ("quad", "wide", "mma")),
        f"{fa.KERNEL}_sliced",
        *(f"{entry}_{family}" for entry in (fa.KERNEL_DQ, fa.KERNEL_DKV)
          for family in ("tiled", "tiled_mma")),
    ])


def test_families_match_the_c_side():
    """``FAMILIES`` lists the kernel families in the order of the C side's
    ``flash::kFamily*`` codes, which the entry points write back."""
    import re

    from gordo_tpu_torch.ops import _build

    header = (_build.CSRC_DIR / "flash_common.cuh").read_text()
    codes = {name: int(code) for name, code in
             re.findall(r"constexpr int kFamily(\w+) = (\d+);", header)}
    assert sorted(codes.values()) == list(range(len(fa.FAMILIES)))
    for name, code in codes.items():
        assert fa.FAMILIES[code].replace("_", "") == name.lower(), name


# bytes of shared memory a block may take on the card (227 KB)
_BLOCK_SMEM = 232448


def _tiling(source: str, struct: str) -> dict:
    """The constants of ``struct <struct> { static constexpr int ...; }`` in
    a CUDA source of the port."""
    import re

    from gordo_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / source).read_text()
    body = re.search(r"struct %s \{\n  static constexpr int ([^;]*);" % struct, text).group(1)
    return {name: int(value) for name, value in
            (item.split(" = ") for item in body.split(", "))}


@pytest.mark.parametrize("struct,elem_bytes", [
    ("DqTiledTiling", 4), ("DkvTiledTiling", 4),  # float32, and float64 staged as float32
    ("DqTiledMmaTiling", 2), ("DkvTiledMmaTiling", 2),  # bfloat16 and float16
])
def test_max_head_dim_is_the_kernels_limit(struct, elem_bytes):
    """No head_dim limit is left, and nothing streams: a block of the tiled
    dq and dk/dv kernels above 256 holds a fixed number of rows and one
    column slice of its outputs whatever the width, so its shared memory
    (the two-stage chunk ring, the slice tiles, the float32 score tiles)
    fits the 227 KB a block may take, at least twice over for the sweep's
    two blocks an SM; the streamed rowwise constants are gone."""
    from gordo_tpu_torch.ops import _build

    header = (_build.CSRC_DIR / "flash_common.cuh").read_text()
    assert "kMaxSharedRowDim" not in header and "kRowChunk" not in header
    assert not hasattr(fa, "MAX_SHARED_ROW_DIM")
    assert fa.kernel_width(10**6) == 10**6 + 64
    tile = _tiling("flash_attention_bwd.cu", struct)
    pad = 16 // elem_bytes
    if struct == "DqTiledTiling":
        ring = 4 * (tile["kRows"] + tile["kKeys"]) * (tile["kChunk"] + pad) * elem_bytes
        rest = (tile["kKeys"] * (tile["kSlice"] + pad) * elem_bytes
                + tile["kRows"] * (tile["kKeys"] + 4) * 4)
    elif struct == "DkvTiledTiling":
        ring = 4 * (tile["kRows"] + tile["kQueries"]) * (tile["kChunk"] + pad) * elem_bytes
        rest = (2 * tile["kQueries"] * (tile["kSlice"] + pad) * elem_bytes
                + (2 * tile["kRows"] * (tile["kQueries"] + 4) + 2 * tile["kQueries"]) * 4)
    elif struct == "DqTiledMmaTiling":  # 64 query rows a block
        ring = 4 * (64 + tile["kKeys"]) * (tile["kChunk"] + pad) * elem_bytes
        rest = tile["kKeys"] * (tile["kSlice"] + pad) * elem_bytes
    else:  # 64 key rows a block
        ring = 4 * (64 + tile["kQueries"]) * (tile["kChunk"] + pad) * elem_bytes
        rest = 2 * tile["kQueries"] * (tile["kSlice"] + pad) * elem_bytes + 2 * tile["kQueries"] * 4
    assert ring + rest <= _BLOCK_SMEM // 2, (struct, ring + rest)
    # every padded width above 256 is a whole number of chunks and slices
    assert 128 % tile["kSlice"] == 0 and 128 % tile["kChunk"] == 0


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_sources_are_listed():
    from gordo_tpu_torch.ops import _build

    assert fa.KERNEL in _build.sources()
    assert _build.library_path(fa.KERNEL).parent == _build.BUILD_DIR


@pytest.mark.parametrize("head_dim,width", [(1, 16), (8, 16), (12, 16), (16, 16), (17, 32),
                                            (24, 32), (33, 64), (48, 64), (64, 64),
                                            (65, 128), (96, 128), (128, 128),
                                            (129, 256), (200, 256), (256, 256),
                                            (257, 384), (300, 384), (384, 384), (385, 512),
                                            (640, 640), (1000, 1024), (1024, 1024),
                                            (1025, 1152), (1100, 1152), (2048, 2048),
                                            (3000, 3072)])
def test_kernel_width_pads_to_the_next_kernel(head_dim, width, monkeypatch):
    """The width a head_dim runs at, on the card and on the CPU alike: the
    CPU's plain version gets the same zero-padded tensors."""
    assert fa.kernel_width(head_dim) == width
    widths = []
    reference = fa.flash_attention_reference

    def spy(q, *args):
        widths.append(q.shape[-1])
        return reference(q, *args)

    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    out, _ = fa.flash_attention_forward(*(torch.zeros(1, 3, 1, head_dim) for _ in range(3)))
    assert widths == [width] and out.shape == (1, 3, 1, head_dim)


def test_kernel_width_names_the_queue_above_128():
    """Above 256 the width is the JAX wrapper's padding, the next multiple
    of 128 (257 and 300 run at 384, 640 at 640, 1025 at 1152, 2048 at
    2048), with no upper limit; the CPU runs the plain version at that
    padded width too, with the caller's LSE."""
    assert [fa.kernel_width(d) for d in (257, 300, 640, 1025, 2048)] == [384, 384, 640, 1152,
                                                                          2048]
    head_dim = 1100
    q, k, v = _qkv((1, 5, 1, head_dim), seed=3)
    out, lse = fa.flash_attention_forward(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (1, 5, 1, head_dim)
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, False), atol=ATOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("width", [64, 128])
def test_16_bit_dq_at_64_and_128_routes_to_the_tensor_cores(dtype, width):
    """bfloat16 and float16 at kernel widths 64 and 128 run the tensor-core
    kernel of every entry point, dq's included (chip_smoke.expected_kernel,
    which the card checks hold every launch to); float32 and float64 keep
    the wide kernels; above 256 the forward runs the sliced kernel and the
    backward the tiled ones, on the tensor cores in bfloat16/float16 and
    on the CUDA cores in float32/float64."""
    import chip_smoke

    assert "mma" in fa.KERNEL_FAMILIES[fa.KERNEL_DQ]
    for entry in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV):
        assert chip_smoke.expected_kernel(entry, dtype, width) == f"{entry}_mma"
        assert chip_smoke.expected_kernel(entry, "float32", width) == f"{entry}_wide"
        assert chip_smoke.expected_kernel(entry, dtype, 256) == f"{entry}_wide"
    assert chip_smoke.expected_kernel(fa.KERNEL, dtype, 1152) == f"{fa.KERNEL}_sliced"
    assert "sliced" in fa.KERNEL_FAMILIES[fa.KERNEL]
    for entry in (fa.KERNEL_DQ, fa.KERNEL_DKV):
        assert chip_smoke.expected_kernel(entry, dtype, 1152) == f"{entry}_tiled_mma"
        assert chip_smoke.expected_kernel(entry, "float32", 384) == f"{entry}_tiled"
        assert chip_smoke.expected_kernel(entry, "float64", 2048) == f"{entry}_tiled"
        assert {"tiled", "tiled_mma"} <= set(fa.KERNEL_FAMILIES[entry])
        assert "rowwise" not in fa.KERNEL_FAMILIES[entry]


@pytest.mark.parametrize("shape", [(1, 1 << 31, 1, 16), (1 << 16, 4, 1 << 15, 16)])
def test_kernels_refuse_shapes_past_int32(shape):
    """The C interface takes batch * heads, seq and head_dim as int32: a
    wider shape raises, naming it, before any launch."""
    q = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="int32"):
        fa._check_kernel_inputs(q)
