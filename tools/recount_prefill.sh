#!/bin/bash
# The dry-run cells repaired for faults F24 and F26 (every arch's
# prefill_32k on pod16x16 and pod2x16x16 but xlstm-125m's, and
# smollm-360m's train_4k on pod2x16x16) counted by tools/mesh_peaks.py
# under this host's torch, JOBS at a time (default 6), one JSON line a
# cell into OUT (default artifacts/recount.jsonl). Hold them to the
# records with
#   python3 tools/dryrun_compare.py --recount OUT
# Usage: bash tools/recount_prefill.sh [OUT]
cd "$(dirname "$0")/.."
out="${1:-artifacts/recount.jsonl}"
mkdir -p "$(dirname "$out")"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
t0=$(date +%s)
{ for a in qwen1.5-110b mistral-large-123b qwen2.5-14b smollm-360m qwen2-vl-7b \
           zamba2-2.7b whisper-medium olmoe-1b-7b granite-moe-3b-a800m; do
    echo "--shape prefill_32k $a"; echo "--shape prefill_32k --multipod $a"; done
  echo "--shape train_4k --multipod smollm-360m"; } \
  | xargs -P "${JOBS:-6}" -I{} bash -c 'python3 tools/mesh_peaks.py {} 2>/dev/null' \
  > "$out"
echo "recount: $(wc -l < "$out") cells in $(( $(date +%s) - t0 )) s"
