"""
The flash kernels' per-call plan, decided in Python: whether every row of
every tensor a kernel moves row by row is 16-byte aligned
(``rows_16b_aligned``), and the ``mode`` bits each wrapper hands its
kernel. The kernels take the 16-byte path (cp.async staging, vector
stores) only with ``MODE_VEC16``; any other view goes through the same
kernel's element-by-element path. The kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py); here a stand-in for the
launch records the arguments the wrappers pass.
"""

import contextlib

import pytest
import torch

from gordo_tpu_torch.ops import flash_attention as fa

SHAPE = (4, 64, 4, 16)


def _offset_view(shape, dtype, offset):
    """A (B, S, H, D) view starting ``offset`` elements into aligned memory."""
    n = shape[0] * shape[1] * shape[2] * shape[3]
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_contiguous_tensors_take_the_16_byte_path(dtype):
    q = torch.zeros(SHAPE, dtype=dtype)
    assert q.data_ptr() % 16 == 0
    assert fa.rows_16b_aligned(q, q.clone(), q.clone())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_slices_of_one_projection_are_aligned(dtype):
    """The card test's q, k, v: ``wide[..., 16:32]`` views of one tensor,
    row starts 16 elements apart."""
    wide = torch.zeros(SHAPE[:3] + (48,), dtype=dtype)
    q, k, v = wide[..., :16], wide[..., 16:32], wide[..., 32:]
    assert not k.is_contiguous()
    assert fa.rows_16b_aligned(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_element_offset_takes_the_scalar_path(dtype):
    q = torch.zeros(SHAPE, dtype=dtype)
    shifted = _offset_view(SHAPE, dtype, 1)
    assert not fa.rows_16b_aligned(shifted)
    assert not fa.rows_16b_aligned(q, q, shifted)


@pytest.mark.parametrize(
    "dtype,offset,aligned",
    [
        (torch.float32, 4, True),  # 16 bytes
        (torch.float32, 2, False),  # 8 bytes
        (torch.bfloat16, 8, True),  # bf16's granule: 8 elements, 16 bytes
        (torch.bfloat16, 4, False),  # 8 bytes
        (torch.bfloat16, 16, True),
        (torch.float16, 8, True),  # float16's granule: 8 elements
        (torch.float16, 4, False),
        (torch.float16, 2, False),
        (torch.float64, 2, True),  # float64's granule: 2 elements
        (torch.float64, 1, False),
        (torch.float64, 3, False),
    ],
)
def test_alignment_granule_is_16_bytes(dtype, offset, aligned):
    assert fa.rows_16b_aligned(_offset_view(SHAPE, dtype, offset)) is aligned


@pytest.mark.parametrize("width,aligned", [(20, True), (18, False)])
def test_row_strides_must_be_16_byte_multiples(width, aligned):
    """A head stride of 20 floats (80 bytes) keeps every row aligned; one
    of 18 (72 bytes) does not, though the first row is."""
    q = torch.zeros(SHAPE[:3] + (width,))[..., :16]
    assert fa.rows_16b_aligned(q) is aligned


@pytest.mark.parametrize(
    "dtype,width,aligned",
    [
        (torch.float16, 24, True),  # 48 bytes
        (torch.float16, 20, False),  # 40 bytes
        (torch.float64, 18, True),  # 144 bytes
        (torch.float64, 17, False),  # 136 bytes
    ],
)
def test_row_strides_of_2_and_8_byte_elements(dtype, width, aligned):
    """The granule is 16 bytes whatever the element: a float16 head stride
    of 24 elements and a float64 one of 18 keep every row aligned."""
    q = torch.zeros(SHAPE[:3] + (width,), dtype=dtype)[..., :16]
    assert fa.rows_16b_aligned(q) is aligned


@pytest.mark.parametrize(
    "dtype,code",
    [(torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2), (torch.float64, 3)],
)
def test_kernels_take_four_dtypes(dtype, code):
    q = torch.zeros(SHAPE, dtype=dtype)
    fa._check_kernel_inputs(q)
    assert fa._shape_args(q) == (*SHAPE, code)


@pytest.mark.parametrize("dtype", [torch.int32, torch.complex64])
def test_kernels_refuse_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float16 or float64"):
        fa._check_kernel_inputs(torch.zeros(SHAPE, dtype=dtype))


def test_mode_bits():
    q = torch.zeros(SHAPE)
    shifted = _offset_view(SHAPE, torch.float32, 1)
    assert fa._mode(True, q) == fa.MODE_CAUSAL | fa.MODE_VEC16
    assert fa._mode(False, q) == fa.MODE_VEC16
    assert fa._mode(True, q, shifted) == fa.MODE_CAUSAL
    # no tensors named: no 16-byte bit
    assert fa._mode(True) == fa.MODE_CAUSAL


@pytest.fixture
def launches(monkeypatch):
    """Stand in for the built kernels: record each launch's arguments."""
    calls = []
    monkeypatch.setattr(fa, "forward_splits", lambda q, causal: 1)
    monkeypatch.setattr(fa, "dq_splits", lambda q, causal: 1)
    monkeypatch.setattr(fa, "dkv_splits", lambda q, causal: 1)
    monkeypatch.setattr(fa, "_kernel_function", lambda kernel, n_pointers: kernel)
    monkeypatch.setattr(fa, "_call", lambda kernel, fn, q, args: calls.append((kernel, args)))
    return calls


def _inputs(offset, n=4):
    return [_offset_view(SHAPE, torch.float32, offset) for _ in range(n)]


@pytest.mark.parametrize("offset,vec", [(0, fa.MODE_VEC16), (1, 0)])
@pytest.mark.parametrize("causal", [False, True])
def test_wrappers_pass_the_plan_to_their_kernels(launches, offset, vec, causal):
    q, k, v, d_out = _inputs(offset)
    batch, seq, heads, _ = SHAPE
    lse = torch.zeros(batch * heads, seq)
    out, _ = fa._launch(q, k, v, causal, 0.25)
    fa._launch_dq(q, k, v, out, lse, d_out, causal, 0.25)
    fa._launch_dkv(q, k, v, lse, lse.clone(), d_out, causal, 0.25)
    modes = {kernel: args[-1] for kernel, args in launches}
    causal_bit = fa.MODE_CAUSAL if causal else 0
    assert modes == {
        fa.KERNEL: causal_bit | vec,
        fa.KERNEL_DQ: causal_bit | vec,
        fa.KERNEL_DKV: causal_bit | vec,
    }


@pytest.mark.parametrize("odd", ["out", "d_out"])
def test_dq_needs_all_six_row_tensors_aligned(launches, odd):
    """dq moves q, k, v, out, d_out and dq row by row: one of them one
    element off takes dq's 16-byte bit away, while the forward, which
    moves q, k, v and its own output, keeps it."""
    q, k, v, d_out = _inputs(0)
    rows = {"out": _offset_view(SHAPE, torch.float32, 0), "d_out": d_out}
    rows[odd] = _offset_view(SHAPE, torch.float32, 1)
    batch, seq, heads, _ = SHAPE
    lse = torch.zeros(batch * heads, seq)
    fa._launch(q, k, v, True, 0.25)
    fa._launch_dq(q, k, v, rows["out"], lse, rows["d_out"], True, 0.25)
    modes = {kernel: args[-1] for kernel, args in launches}
    assert modes == {
        fa.KERNEL: fa.MODE_CAUSAL | fa.MODE_VEC16,
        fa.KERNEL_DQ: fa.MODE_CAUSAL,
    }


@pytest.mark.parametrize("head_dim,width", [(8, 16), (12, 16), (24, 32), (48, 64), (96, 128),
                                            (129, 256), (200, 256), (257, 384), (300, 384),
                                            (640, 640), (1100, 1152), (2048, 2048)])
def test_wrappers_launch_at_the_kernel_width(launches, monkeypatch, head_dim, width):
    """On the card's path each wrapper and the Function launch at the next
    kernel width with the caller's scale, 1/sqrt(head_dim), and hand back
    tensors of the caller's head_dim."""
    monkeypatch.setattr(fa, "_device_path", lambda name, q: "cuda")
    shape = (2, 5, 3, head_dim)
    q, k, v, d_out = (torch.randn(shape) for _ in range(4))
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, d_out, causal=True)
    assert all(x.shape == shape for x in (out, dq, dk, dv))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert all(leaf.grad.shape == shape for leaf in leaves)
    pointers = {fa.KERNEL: 6, fa.KERNEL_DQ: 9, fa.KERNEL_DKV: 9}
    assert [kernel for kernel, _ in launches] == [fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV] * 2
    for kernel, args in launches:
        assert args[pointers[kernel] + 3] == width, kernel
        assert args[-2] == pytest.approx(head_dim ** -0.5), kernel


@pytest.mark.parametrize("splits", [1, 3])
def test_forward_hands_its_kernel_the_split_scratch(launches, monkeypatch, splits):
    """With key splits the forward passes a float32 scratch of splits x
    batch x heads x seq x (head_dim + 2) elements (each split's rows and
    row statistics), and none without."""
    monkeypatch.setattr(fa, "forward_splits", lambda q, causal: splits)
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        sizes.append(shape[0] if len(shape) == 1 else shape)
        return empty(*shape, **kwargs)

    monkeypatch.setattr(torch, "empty", recording_empty)
    q, k, v, _ = _inputs(0)
    fa._launch(q, k, v, True, 0.25)
    (kernel, args), = launches
    batch, seq, heads, head_dim = SHAPE
    if splits == 1:
        assert args[5] is None
    else:
        assert isinstance(args[5], int) and args[5] != 0
        assert splits * batch * heads * seq * (head_dim + 2) in sizes


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.float64])
def test_dq_hands_its_kernel_the_split_scratch(launches, monkeypatch, splits, dtype):
    """With key splits the dq kernel gets a float32 scratch of splits x
    batch x heads x seq x head_dim elements (each split's unscaled dq
    rows), whatever the element type, and none without."""
    monkeypatch.setattr(fa, "dq_splits", lambda q, causal: splits)
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        sizes.append((shape[0] if len(shape) == 1 else shape, kwargs.get("dtype")))
        return empty(*shape, **kwargs)

    monkeypatch.setattr(torch, "empty", recording_empty)
    q, k, v, out, d_out = (torch.zeros(SHAPE, dtype=dtype) for _ in range(5))
    batch, seq, heads, head_dim = SHAPE
    lse = torch.zeros(batch * heads, seq)
    fa._launch_dq(q, k, v, out, lse, d_out, True, 0.25)
    (kernel, args), = launches
    assert kernel == fa.KERNEL_DQ
    scratch = (splits * batch * heads * seq * head_dim, torch.float32)
    if splits == 1:
        assert args[8] is None
        assert scratch not in sizes
    else:
        assert isinstance(args[8], int) and args[8] != 0
        assert scratch in sizes


@pytest.mark.parametrize("entry", [fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV])
@pytest.mark.parametrize("family", fa.FAMILIES)
def test_call_counts_the_kernel_family_the_entry_point_reports(monkeypatch, entry, family):
    """The C entry point writes the family of the kernel it launched to its
    last argument; ``_call`` counts the launch by entry point and by that
    kernel, and refuses a family the entry point has no kernel of."""
    import ctypes

    def entry_point(*args):
        ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))[0] = fa.FAMILIES.index(family)
        return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(fa, "launch_counts", dict(fa.launch_counts))
    monkeypatch.setattr(fa, "kernel_launches", dict(fa.kernel_launches))
    fa.reset_launch_counts()
    q = torch.zeros(SHAPE)
    if family not in fa.KERNEL_FAMILIES[entry]:
        with pytest.raises(KeyError):
            fa._call(entry, entry_point, q, ())
        return
    fa._call(entry, entry_point, q, ())
    fa._call(entry, entry_point, q, ())
    assert fa.launch_counts == {name: 2 if name == entry else 0 for name in fa.launch_counts}
    assert fa.kernel_launches == {
        name: 2 if name == f"{entry}_{family}" else 0 for name in fa.kernel_launches
    }


def test_call_raises_on_a_launch_error(monkeypatch):
    """A refused launch raises with its CUDA error and counts nothing."""
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    before = dict(fa.launch_counts), dict(fa.kernel_launches)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fa._call(fa.KERNEL, lambda *args: 1, torch.zeros(SHAPE), ())
    assert (fa.launch_counts, fa.kernel_launches) == before


@pytest.mark.parametrize("head_dim,dq_parts,dkv_parts",
                         [(384, 1, 1), (1024, 1, 1), (1152, 3, 1), (2048, 1, 4), (640, 2, 2)])
def test_backward_above_256_gets_the_split_scratch_it_asks_for(launches, monkeypatch, head_dim,
                                                              dq_parts, dkv_parts):
    """Above 256 nothing streams: the tiled dq and dk/dv kernels get a
    scratch only when the C side's split query asks for splits, a float32
    one of splits x batch x heads x seq x head_dim elements for dq (each
    split's dq rows) and twice that for dk/dv (each split's dk and dv
    rows), whatever the element type; without splits neither gets one."""
    monkeypatch.setattr(fa, "dq_splits", lambda q, causal: dq_parts)
    monkeypatch.setattr(fa, "dkv_splits", lambda q, causal: dkv_parts)
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        sizes.append((shape[0] if len(shape) == 1 else shape, kwargs.get("dtype")))
        return empty(*shape, **kwargs)

    monkeypatch.setattr(torch, "empty", recording_empty)
    shape = (2, 5, 3, head_dim)
    q, k, v, out, d_out = (torch.zeros(shape, dtype=torch.bfloat16) for _ in range(5))
    lse = torch.zeros(2 * 3, 5)
    fa._launch_dq(q, k, v, out, lse, d_out, True, 0.25)
    fa._launch_dkv(q, k, v, lse, lse.clone(), d_out, True, 0.25)
    (_, dq_args), (_, dkv_args) = launches
    rows = 2 * 3 * 5 * head_dim
    assert (dq_args[8] is not None) == (dq_parts > 1)
    assert (dkv_args[8] is not None) == (dkv_parts > 1)
    scratch = [size for size, dtype in sizes if dtype == torch.float32 and size != (6, 5)]
    want = ([dq_parts * rows] if dq_parts > 1 else []) + (
        [dkv_parts * 2 * rows] if dkv_parts > 1 else [])
    assert scratch == want
