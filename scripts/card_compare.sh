#!/usr/bin/env bash
# Times a parent tree of the port against a changed tree on one card, in
# turns (parent, change, change, parent), so both see the same host and card.
#
#   rm -rf _checkout && mkdir -p _checkout/parent _checkout/change
#   git archive <parent commit> | tar -x -C _checkout/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C _checkout/change
#   # then, from the repo root on the host with the card (~10 minutes):
#   bash scripts/card_compare.sh _checkout/parent _checkout/change <out dir>
#
# Each tree is a checkout of the repo (for example a `git archive`). Writes
# <out>/{parent1,change1,change2,parent2}.{json,log} from each tree's own
# `chip_smoke.py --out`, and <out>/{parent,change}_kernel_check.txt from
# the change's `scripts/flash_kernel_check.py --root <tree>`, so both
# trees' kernels run the same cases, and <out>/kernel_check_compare.txt
# with the two trees' kernel times side by side; then runs the change's
# card tests.
# Prints the card's name and power limit, each run's exit code and the
# tail of its log. Exits non-zero if any run failed.
set -u
parent=$(realpath "$1")
change=$(realpath "$2")
out=$(realpath -m "$3")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
status=0
for run in "parent1:$parent" "change1:$change" "change2:$change" "parent2:$parent"; do
  label=${run%%:*}
  (cd "${run#*:}" && python3 chip_smoke.py --out "$out/$label.json") >"$out/$label.log" 2>&1
  rc=$?
  echo "$label rc=$rc"
  tail -n 3 "$out/$label.log"
  [ "$rc" -eq 0 ] || status=1
done
for run in "parent:$parent" "change:$change"; do
  label=${run%%:*}
  (cd "$change" && python3 scripts/flash_kernel_check.py --root "${run#*:}") \
    >"$out/${label}_kernel_check.txt" 2>&1
  rc=$?
  echo "$label kernel check rc=$rc"
  tail -n 1 "$out/${label}_kernel_check.txt"
  [ "$rc" -eq 0 ] || status=1
done
# both trees' kernel-check times side by side, case by case (a case the
# parent refuses, such as a head_dim it does not take, prints as refused)
python3 - "$out" <<'PY' | tee "$out/kernel_check_compare.txt"
import json, sys
rows = {}
for label in ("parent", "change"):
    with open(f"{sys.argv[1]}/{label}_kernel_check.txt") as fh:
        for line in fh:
            if line.startswith("{"):
                row = json.loads(line)
                rows.setdefault(row["case"], {})[label] = row
for case, by_tree in rows.items():
    cells = []
    for label in ("parent", "change"):
        row = by_tree.get(label, {})
        if "refused" in row:
            cells.append(f"{label} refused")
        elif row:
            cells.append(f"{label} fwd {row['fwd_ms']:.4f} dq {row['dq_ms']:.4f} "
                         f"dkv {row['dkv_ms']:.4f}")
    sdpa = by_tree.get("change", {}).get("sdpa_ms")
    print(f"{case}: " + " | ".join(cells) + (f" | sdpa fwd {sdpa:.4f}" if sdpa else ""))
PY
(cd "$change" && python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py) 2>&1 | tail -n 2
[ "${PIPESTATUS[0]}" -eq 0 ] || status=1
exit "$status"
