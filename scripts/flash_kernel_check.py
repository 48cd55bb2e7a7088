#!/usr/bin/env python3
"""
Quick card check of the flash kernels alone, without the serving and
training phases of ``chip_smoke.py``.

    python3 scripts/flash_kernel_check.py [--root CHECKOUT]

Builds the kernels, then for each case (contiguous tensors, head slices of
one wider tensor, views one element into their memory; float32, bfloat16,
float16 and float64; head_dim 8 to 3000, padded to the next kernel width)
holds the forward, the dq and the dk/dv kernel against their plain
versions (``chip_smoke.TOLERANCE``), checks that two forward, two dq (dq
and delta) and two dk/dv launches agree bit for bit and that each entry
point ran the CUDA kernel its width and type route to
(``chip_smoke.expected_kernel``: the tensor-core kernels for
bfloat16/float16 at 64 and 128, the width-sliced forward and the tiled
dq and dk/dv above 256), and prints one JSON row per case with the
kernels that ran, dq's key splits and dk/dv's query splits and the
device times (torch.profiler) of the three
kernels and of ``scaled_dot_product_attention``. Exits non-zero if a
case fails. ``--case NAME`` (repeatable) runs only the named cases.

``--root`` times the port of another checkout (an older commit, for a
comparison in one call) with this script's cases; a case whose shape that
port's wrappers refuse (a head_dim it does not pad) is printed as
refused, and fails only for this script's own checkout; that port's
kernels are reported, not held to this checkout's routing.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# (name, (B, S, H, D), causal, dtype name, layout)
CASES = [
    ("served", (8192, 64, 4, 16), True, "float32", "contiguous"),
    ("train", (32, 64, 4, 16), True, "float32", "contiguous"),
    ("ragged-16", (2, 37, 2, 16), False, "float32", "contiguous"),
    ("ragged-16-causal", (3, 130, 2, 16), True, "float32", "contiguous"),
    ("head-dim-32", (16, 200, 2, 32), True, "float32", "contiguous"),
    ("head-dim-32-full", (3, 301, 2, 32), False, "float32", "contiguous"),
    ("served-bf16", (8192, 64, 4, 16), True, "bfloat16", "contiguous"),
    ("bf16-32", (8, 100, 2, 32), True, "bfloat16", "contiguous"),
    ("train-misaligned", (32, 64, 4, 16), True, "float32", "misaligned"),
    ("train-head-slices", (32, 64, 4, 16), True, "float32", "slices"),
    ("bf16-32-misaligned", (8, 100, 2, 32), True, "bfloat16", "misaligned"),
    ("bf16-16-misaligned", (8, 100, 2, 16), True, "bfloat16", "misaligned"),
    ("head-dim-32-slices-full", (4, 77, 2, 32), False, "float32", "slices"),
    ("head-dim-64", (4, 1000, 2, 64), True, "float32", "contiguous"),
    ("head-dim-64-full", (4, 1000, 2, 64), False, "float32", "contiguous"),
    ("head-dim-128", (2, 300, 2, 128), False, "float32", "contiguous"),
    ("head-dim-128-causal", (3, 301, 2, 128), True, "float32", "contiguous"),
    ("long-context-64", (1, 8192, 4, 64), True, "float32", "contiguous"),
    ("long-context-64-bf16", (1, 8192, 4, 64), True, "bfloat16", "contiguous"),
    ("head-dim-64-slices", (4, 77, 2, 64), True, "float32", "slices"),
    ("head-dim-64-misaligned", (3, 301, 2, 64), True, "float32", "misaligned"),
    ("bf16-128-misaligned", (3, 131, 2, 128), False, "bfloat16", "misaligned"),
    ("padded-8", (32, 64, 4, 8), True, "float32", "contiguous"),
    ("padded-48", (16, 200, 2, 48), True, "float32", "contiguous"),
    ("padded-96-full", (3, 150, 2, 96), False, "float32", "contiguous"),
    ("head-dim-256", (2, 300, 2, 256), False, "float32", "contiguous"),
    ("head-dim-256-causal-bf16", (2, 257, 2, 256), True, "bfloat16", "contiguous"),
    ("head-dim-256-misaligned", (1, 130, 2, 256), True, "float32", "misaligned"),
    ("padded-200", (2, 512, 4, 200), True, "float32", "contiguous"),
    ("dq-split-64", (1, 500, 1, 64), True, "float32", "contiguous"),
    ("dq-split-128-slices", (1, 300, 2, 128), False, "float32", "slices"),
    ("fp16-64", (4, 1000, 2, 64), True, "float16", "contiguous"),
    ("fp16-16", (8, 100, 2, 16), True, "float16", "contiguous"),
    ("fp16-32-misaligned", (8, 100, 2, 32), False, "float16", "misaligned"),
    ("fp64-128", (2, 300, 2, 128), False, "float64", "contiguous"),
    ("fp64-16-misaligned", (8, 100, 2, 16), True, "float64", "misaligned"),
    ("fp64-256-causal", (1, 200, 2, 256), True, "float64", "contiguous"),
    # bfloat16 and float16 at kernel widths 64 and 128: the tensor-core
    # forward and dk/dv kernels (dq stays on the wide kernel)
    ("bf16-64", (4, 1000, 2, 64), True, "bfloat16", "contiguous"),
    ("bf16-64-full", (4, 1000, 2, 64), False, "bfloat16", "contiguous"),
    ("bf16-128", (2, 300, 2, 128), False, "bfloat16", "contiguous"),
    ("fp16-128", (2, 300, 2, 128), False, "float16", "contiguous"),
    ("fp16-128-causal", (3, 301, 2, 128), True, "float16", "contiguous"),
    ("padded-48-bf16", (16, 200, 2, 48), True, "bfloat16", "contiguous"),
    ("padded-48-fp16", (16, 200, 2, 48), True, "float16", "contiguous"),
    ("padded-96-bf16-full", (3, 150, 2, 96), False, "bfloat16", "contiguous"),
    ("bf16-64-misaligned", (3, 301, 2, 64), True, "bfloat16", "misaligned"),
    ("fp16-64-slices", (4, 77, 2, 64), True, "float16", "slices"),
    ("bf16-64-split", (1, 500, 1, 64), False, "bfloat16", "contiguous"),
    ("fp16-128-split-causal", (1, 300, 2, 128), True, "float16", "contiguous"),
    # above 256: the run-time-width kernels (the sliced forward, the tiled
    # dq and dk/dv), at the JAX padding
    ("head-dim-300", (2, 300, 2, 300), True, "float32", "contiguous"),
    ("head-dim-300-bf16", (2, 300, 2, 300), True, "bfloat16", "contiguous"),
    ("head-dim-300-fp16", (2, 300, 2, 300), True, "float16", "contiguous"),
    ("head-dim-300-fp64", (1, 130, 2, 300), True, "float64", "contiguous"),
    ("head-dim-640", (1, 256, 2, 640), False, "float32", "contiguous"),
    ("head-dim-640-bf16", (1, 256, 2, 640), False, "bfloat16", "contiguous"),
    ("head-dim-640-fp16", (1, 256, 2, 640), True, "float16", "contiguous"),
    ("head-dim-640-fp64", (1, 128, 1, 640), True, "float64", "contiguous"),
    ("head-dim-384-slices", (2, 50, 2, 384), False, "float32", "slices"),
    ("head-dim-1024-misaligned", (1, 100, 1, 1024), True, "float32", "misaligned"),
    ("head-dim-1100", (1, 128, 2, 1100), True, "float32", "contiguous"),
    ("head-dim-1100-bf16", (1, 128, 2, 1100), False, "bfloat16", "contiguous"),
    ("head-dim-1100-fp16", (1, 96, 1, 1100), True, "float16", "contiguous"),
    ("head-dim-1100-fp64", (1, 70, 1, 1100), True, "float64", "contiguous"),
    ("head-dim-2048", (1, 64, 1, 2048), False, "float32", "contiguous"),
    ("head-dim-2048-bf16", (1, 64, 1, 2048), False, "bfloat16", "contiguous"),
    ("head-dim-1152-misaligned", (1, 50, 2, 1152), True, "float32", "misaligned"),
    ("head-dim-3000-slices", (1, 40, 1, 3000), True, "float32", "slices"),
    ("head-dim-384-bf16-misaligned", (1, 100, 2, 384), True, "bfloat16", "misaligned"),
    ("head-dim-640-fp16-slices", (1, 90, 2, 640), False, "float16", "slices"),
    # a launch above 256 that fills the card
    ("head-dim-512-bf16-long", (2, 2048, 4, 512), True, "bfloat16", "contiguous"),
]


def make(torch, gen, shape, dtype, layout):
    if layout == "slices":
        wide = torch.randn(shape[:-1] + (3 * shape[-1],), generator=gen, device="cuda")
        return wide.to(dtype)[..., shape[-1]:2 * shape[-1]]
    return cs.card_tensor(torch, gen, shape, dtype, layout == "misaligned")


def max_err(pairs):
    return max((got.float() - want.float()).abs().max().item() for got, want in pairs)


def check(torch, F, fa, gen, own, name, shape, causal, dtype_name, layout):
    dtype = getattr(torch, dtype_name)
    q, k, v, d_out = (make(torch, gen, shape, dtype, layout) for _ in range(4))
    tol = cs.TOLERANCE[dtype_name]
    scale = 1.0 / math.sqrt(shape[-1])
    padded = torch.empty(shape[:-1] + (fa.kernel_width(shape[-1]),), dtype=dtype, device="cuda")
    # the CUDA kernel each entry point ran (a tree from before the per-kernel
    # counts gives none)
    counts = getattr(fa, "kernel_launches", {})
    before = dict(counts)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    out2, lse2 = fa.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, d_out, causal, scale
    )
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal)
    dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal)
    torch.cuda.synchronize()
    ran = sorted(name for name in counts if counts[name] != before[name])
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, lse, ref_delta, d_out, causal, scale
    )
    qt, kt, vt = (cs.library_view(x) for x in (q, k, v))
    row = {
        "case": name,
        "shape": list(shape),
        "causal": causal,
        "dtype": dtype_name,
        "rows_16b_aligned": fa.rows_16b_aligned(q, k, v),
        "dq_splits": fa.dq_splits(padded, causal) if hasattr(fa, "dq_splits") else None,
        "dkv_splits": fa.dkv_splits(padded, causal) if hasattr(fa, "dkv_splits") else None,
        "fwd_err": max_err([(out, ref_out), (lse, ref_lse)]),
        "fwd_bitwise": bool(torch.equal(out, out2) and torch.equal(lse, lse2)),
        "dq_err": max_err([(dq, ref_dq), (delta, ref_delta)]),
        "dq_bitwise": bool(torch.equal(dq, dq2) and torch.equal(delta, delta2)),
        "dkv_err": max_err([(dk, ref_dk), (dv, ref_dv)]),
        "dkv_bitwise": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
        "kernels": ran,
    }
    timed = {
        "fwd": lambda: fa.flash_attention_forward(q, k, v, causal=causal),
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, d_out, causal),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, ref_delta, d_out, causal),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
    }
    for label, fn in timed.items():
        # the timer beside each time: "events" is not a device time
        row[f"{label}_ms"], row[f"{label}_timer"] = cs.device_ms(fn)
    for label, dots in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        n_tensors, n_stats = (4, 1) if label == "fwd" else (6, 2)
        row[f"{label}_bound_ms"], row[f"{label}_bound_by"] = cs.attention_bound(
            shape, causal, dtype_name, q.element_size(), n_tensors, n_stats, dots
        )
    width = fa.kernel_width(shape[-1])
    expected = sorted(cs.expected_kernel(entry, dtype_name, width)
                      for entry in (fa.KERNEL, fa.KERNEL_DQ, fa.KERNEL_DKV))
    # another checkout's routing is its own: reported, not held to this one's
    row["expected_kernels"] = expected
    ok = (max(row["fwd_err"], row["dq_err"], row["dkv_err"]) <= tol
          and row["fwd_bitwise"] and row["dq_bitwise"] and row["dkv_bitwise"]
          and (not own or ran == expected))
    return row, ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose port is checked (default: this one)")
    parser.add_argument("--case", action="append", default=None,
                        help="run only the named case (repeatable)")
    args = parser.parse_args()
    root = os.path.realpath(args.root)
    own = root == os.path.realpath(HERE)
    sys.path.insert(0, root)

    import torch
    import torch.nn.functional as F

    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_kernel_check: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    print("port:", os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__))), flush=True)
    t0 = time.perf_counter()
    for source, built in _build.build_all(_build.sources()).items():
        # a tree from before nvcc's seconds were returned gives its output alone
        text, seconds = built if isinstance(built, tuple) else (built, time.perf_counter() - t0)
        print(f"nvcc {source} ({seconds:.1f} s):\n{text.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    failed = []
    for case in CASES:
        if args.case and case[0] not in args.case:
            continue
        try:
            row, ok = check(torch, F, fa, gen, own, *case)
        except ValueError as refused:  # the port's wrappers refuse the shape
            row, ok = {"case": case[0], "shape": list(case[1]), "refused": str(refused)}, not own
        print(json.dumps(row), flush=True)
        if not ok:
            failed.append(row["case"])
        torch.cuda.empty_cache()
    print("failed: " + ", ".join(failed) if failed else "all cases passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
