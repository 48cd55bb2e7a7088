#!/usr/bin/env python3
"""
Times tilings of the flash forward, dq and dk/dv kernels on one card
(head_dim 64/128/256, and the sliced forward above 256), each against the
same inputs, in one process.

    python3 scripts/flash_tiling_sweep.py 'VARIANTS' [--out ROWS.jsonl] [--case NAME ...]

VARIANTS is JSON that maps a variant's name to the constants it changes, e.g.
``{"shipped": {}, "r2": {"fwd64": [2, 4, 4, 64, 3]}, "nosplit":
{"max_splits": 1}}``: ``fwd<D>`` sets ``FwdWideTiling<D>``, ``dq<D>``
``DqWideTiling<D>`` and ``dkv<D>`` ``DkvWideTiling<D>`` as (R, S, kWarps,
kTile, kMinBlocks), for D of 64, 128 or 256; ``fwdmma<D>`` sets the
tensor-core forward's ``FwdMmaTiling<D>`` as (kTile, kMinBlocks),
``dkvmma<D>`` the tensor-core dk/dv's ``DkvMmaTiling<D>`` as (kTile,
kMinBlocks, kKeepKV) and ``dqmma<D>`` the tensor-core dq's
``DqMmaTiling<D>`` as (kTile, kMinBlocks), for D of 64 or 128; ``fwdsliced`` sets the sliced forward's ``FwdSlicedTiling`` as
(kRows, kKeys, kChunk, kSlice, kWarps, kMinBlocks); above 256
``dqtiled`` sets the CUDA-core dq's ``DqTiledTiling`` as (kRows, kKeys,
kChunk, kSlice, kWarps, kMinBlocks), ``dkvtiled`` the CUDA-core dk/dv's
``DkvTiledTiling`` as (kRows, kQueries, kChunk, kSlice, kWarps,
kMinBlocks), ``dqtiledmma`` the tensor-core dq's ``DqTiledMmaTiling`` as
(kKeys, kChunk, kSlice, kMinBlocks) and ``dkvtiledmma`` the tensor-core
dk/dv's ``DkvTiledMmaTiling`` as (kQueries, kChunk, kSlice, kMinBlocks); ``max_splits``
sets ``kMaxSplits``, the limit of every key or query split. Each variant's sources are
copied with those constants replaced and built with the port's nvcc
flags (all variants at once), and nvcc's register and spill lines for
the wide, tensor-core, sliced and tiled kernels are printed. ``--case`` (repeatable)
runs only the named cases. Then, per case, every variant's forward,
dq and dk/dv run against the plain versions (``chip_smoke.TOLERANCE``),
twice for a bitwise repeat, and are timed with ``chip_smoke.device_ms``
beside ``scaled_dot_product_attention`` and the bound. Prints one JSON
row per (case, variant); exits non-zero if a variant fails to build or
disagrees.
"""

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(ROOT, "gordo_tpu_torch", "csrc")
# each variant's sources and libraries, under the port's (git-ignored) build directory
WORK = os.path.join(ROOT, "gordo_tpu_torch", "_build", "tiling_sweep")
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
# (case, (B, S, H, D), causal, dtype, misaligned views)
CASES = [
    ("ragged-causal", (4, 1000, 2, 64), True, "float32", False),
    ("ragged-full", (4, 1000, 2, 64), False, "float32", False),
    ("head-dim-128", (2, 300, 2, 128), False, "float32", False),
    ("head-dim-128-causal", (3, 301, 2, 128), True, "float32", False),
    ("long-context-64", (1, 8192, 4, 64), True, "float32", False),
    ("long-context-64-bf16", (1, 8192, 4, 64), True, "bfloat16", False),
    ("head-dim-128-bf16", (2, 300, 2, 128), True, "bfloat16", False),
    ("head-dim-64-misaligned", (3, 301, 2, 64), True, "float32", True),
    ("small-64-causal", (1, 500, 1, 64), True, "float32", False),
    ("head-dim-256", (2, 300, 2, 256), False, "float32", False),
    ("head-dim-256-causal", (2, 1000, 2, 256), True, "float32", False),
    ("fp16-64", (4, 1000, 2, 64), True, "float16", False),
    ("bf16-128-full", (2, 300, 2, 128), False, "bfloat16", False),
    ("bf16-128-long", (1, 4096, 4, 128), True, "bfloat16", False),
    ("head-dim-300", (2, 300, 2, 300), True, "float32", False),
    ("head-dim-300-bf16", (2, 300, 2, 300), True, "bfloat16", False),
    ("wide-head-model", (4, 256, 2, 300), True, "float32", False),  # chip_smoke's phase 7
    ("wide-head-model-bf16", (4, 256, 2, 300), True, "bfloat16", False),
    ("head-dim-640", (1, 256, 2, 640), False, "float32", False),
    ("head-dim-1100", (1, 128, 2, 1100), True, "float32", False),
    ("head-dim-2048-bf16", (1, 64, 1, 2048), False, "bfloat16", False),
    ("head-dim-512-bf16-long", (2, 2048, 4, 512), True, "bfloat16", False),
    ("head-dim-1100-bf16", (1, 128, 2, 1100), False, "bfloat16", False),
]
STRUCTS = {"fwd": "FwdWideTiling", "dq": "DqWideTiling", "dkv": "DkvWideTiling",
           "fwdmma": "FwdMmaTiling", "dkvmma": "DkvMmaTiling", "dqmma": "DqMmaTiling"}
# the run-time-width tilings: (struct, its constants in order)
RUNTIME_STRUCTS = {
    "fwdsliced": ("FwdSlicedTiling", ("kRows", "kKeys", "kChunk", "kSlice", "kWarps",
                                      "kMinBlocks")),
    "dqtiled": ("DqTiledTiling", ("kRows", "kKeys", "kChunk", "kSlice", "kWarps", "kMinBlocks")),
    "dkvtiled": ("DkvTiledTiling", ("kRows", "kQueries", "kChunk", "kSlice", "kWarps",
                                    "kMinBlocks")),
    "dqtiledmma": ("DqTiledMmaTiling", ("kKeys", "kChunk", "kSlice", "kMinBlocks")),
    "dkvtiledmma": ("DkvTiledMmaTiling", ("kQueries", "kChunk", "kSlice", "kMinBlocks")),
}



def variant_sources(spec: dict, out_dir: str) -> str:
    """Copy the sources into ``out_dir`` with the variant's constants."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as fh:
            text = fh.read()
        for key, values in spec.items():
            if key == "max_splits":
                pattern, value = r"constexpr int kMaxSplits = \d+;", f"constexpr int kMaxSplits = {values};"
            elif key in RUNTIME_STRUCTS:
                struct, names = RUNTIME_STRUCTS[key]
                pattern = r"(struct %s \{\n  static constexpr int )[^;]*;" % struct
                value = r"\g<1>" + ", ".join(
                    f"{name} = {int(v)}" for name, v in zip(names, values, strict=True)) + ";"
            elif key.startswith(("fwdmma", "dkvmma", "dqmma")):
                kernel, width = re.fullmatch(r"([a-z]+)(\d+)", key).groups()
                struct, width = STRUCTS[kernel], int(width)
                pattern = r"(struct %s<%d> \{\n  static constexpr int )[^;]*;" % (struct, width)
                value = r"\g<1>kTile = %d, kMinBlocks = %d;" % tuple(values[:2])
                if kernel == "dkvmma":
                    text = re.sub(pattern + r"(\n  static constexpr bool kKeepKV = )\w+;",
                                  value + r"\g<2>%s;" % ("true" if values[2] else "false"), text)
                    continue
            else:
                kernel, width = re.fullmatch(r"([a-z]+)(\d+)", key).groups()
                struct, width = STRUCTS[kernel], int(width)
                pattern = r"(struct %s<%d> \{\n  static constexpr int )[^;]*;" % (struct, width)
                value = r"\g<1>R = %d, S = %d, kWarps = %d, kTile = %d, kMinBlocks = %d;" % tuple(values)
            text = re.sub(pattern, value, text)
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)
    return out_dir


def nvcc(src_dir: str, stem: str):
    from gordo_tpu_torch.ops import _build

    target = os.path.join(src_dir, stem + ".so")
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", target, os.path.join(src_dir, stem + ".cu")],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return target, proc.stdout + proc.stderr


def wide_registers(text: str):
    """(kernel, registers, spill store bytes) of each wide, tensor-core,
    sliced and tiled kernel nvcc built."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        found = re.search(
            r"Compiling entry function '\S*?(flash_\w+_(?:wide|mma|sliced|tiled)_kernel\w*?)EEEv",
            line)
        if found:
            info = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            yield found.group(1), int(regs.group(1)), int(spill.group(1)) if spill else 0


def main() -> int:
    parser = argparse.ArgumentParser(description="time tilings of the wide flash kernels")
    parser.add_argument("variants", help='JSON: {"name": {"constant": value}}')
    parser.add_argument("--out", help="also append the JSON rows to this file")
    parser.add_argument("--case", action="append", default=None,
                        help="run only the named case (repeatable)")
    args = parser.parse_args()
    variants = json.loads(args.variants)

    import torch
    import torch.nn.functional as F

    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_tiling_sweep: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dirs = {name: variant_sources(spec, os.path.join(WORK, name)) for name, spec in variants.items()}
    libs, failed = {}, []
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        futures = {(name, stem): pool.submit(nvcc, d, stem) for name, d in dirs.items()
                   for stem in SOURCES}
        for (name, stem), future in futures.items():
            try:
                libs[(name, stem)], text = future.result()
            except RuntimeError as error:
                print(f"nvcc failed for {name} {stem}:\n{error}", flush=True)
                failed.append(name)
                continue
            for kernel, regs, spill in wide_registers(text):
                print(json.dumps({"variant": name, "kernel": kernel, "registers": regs,
                                  "spill_bytes": spill}), flush=True)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for case, shape, causal, dtype_name, misaligned in CASES:
        if args.case and case not in args.case:
            continue
        dtype = getattr(torch, dtype_name)
        q, k, v, d_out = (cs.card_tensor(torch, gen, shape, dtype, misaligned) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        # the splits are asked at the kernel width, as the wrappers ask
        padded = torch.empty(shape[:-1] + (fa.kernel_width(shape[-1]),), dtype=dtype,
                             device="cuda")
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
        ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(
            q, k, v, ref_out, ref_lse, d_out, causal, scale)
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, ref_lse, ref_delta, d_out, causal, scale)
        tol = cs.TOLERANCE[dtype_name]
        qt, kt, vt = (cs.library_view(x) for x in (q, k, v))
        sdpa_ms, _ = cs.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        for name in variants:
            if name in failed:
                continue
            for stem in SOURCES:
                _build._loaded[stem] = ctypes.CDLL(libs[(name, stem)])
            fa._splits.cache_clear()  # each variant's library answers for itself

            def fwd():
                return fa.flash_attention_forward(q, k, v, causal=causal)

            def dq():
                return fa.flash_attention_bwd_dq(q, k, v, ref_out, ref_lse, d_out, causal)

            def dkv():
                return fa.flash_attention_bwd_dkv(q, k, v, ref_lse, ref_delta, d_out, causal)

            (out1, lse1), (out2, lse2) = fwd(), fwd()
            dq1, dq2 = dq(), dq()
            dkv1, dkv2 = dkv(), dkv()
            torch.cuda.synchronize()
            row = {
                "case": case, "variant": name, "shape": list(shape), "causal": causal,
                "dtype": dtype_name, "key_splits": fa.forward_splits(padded, causal),
                "dq_splits": fa.dq_splits(padded, causal),
                "dkv_splits": fa.dkv_splits(padded, causal),
                "fwd_err": max((out1.float() - ref_out.float()).abs().max().item(),
                               (lse1 - ref_lse).abs().max().item()),
                "dq_err": max((got.float() - want.float()).abs().max().item()
                              for got, want in zip(dq1, (ref_dq, ref_delta))),
                "dkv_err": max((got.float() - want.float()).abs().max().item()
                               for got, want in zip(dkv1, (ref_dk, ref_dv))),
                "bitwise": bool(torch.equal(out1, out2) and torch.equal(lse1, lse2)
                                and all(torch.equal(a, b) for a, b in zip(dq1, dq2))
                                and all(torch.equal(a, b) for a, b in zip(dkv1, dkv2))),
                "sdpa_fwd_ms": sdpa_ms,
            }
            for label, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
                row[f"{label}_ms"], row[f"{label}_timer"] = cs.device_ms(fn)
            for label, n_tensors, n_stats, dots in (
                    ("fwd", 4, 1, 2), ("dq", 6, 2, 3), ("dkv", 6, 2, 4)):
                row[f"{label}_bound_ms"], row[f"{label}_bound_by"] = cs.attention_bound(
                    shape, causal, dtype_name, q.element_size(), n_tensors, n_stats, dots)
            row["ok"] = (max(row["fwd_err"], row["dq_err"], row["dkv_err"]) <= tol
                         and row["bitwise"])
            if not row["ok"]:
                failed.append(name)
            print(json.dumps(row), flush=True)
            rows.append(row)
        del q, k, v, d_out, ref_out, ref_lse, ref_dq, ref_delta, ref_dk, ref_dv
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as fh:
            fh.writelines(json.dumps(row) + "\n" for row in rows)
    print("failed: " + ", ".join(sorted(set(failed))) if failed else "all variants passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
