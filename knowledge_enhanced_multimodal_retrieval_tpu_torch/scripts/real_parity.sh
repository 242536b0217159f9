#!/usr/bin/env bash
# Real-artifact parity runbook of the PyTorch port: one command from dropped
# CLIP artifacts to PARITY_RESULTS.json (tokenizer goldens -> converter
# cosine -> full R@K), on the card unless --device=cpu is given.
#
# Usage:
#   CLIP_BPE_PATH=/path/bpe_simple_vocab_16e6.txt.gz \
#   CLIP_PT_PATH=/path/ViT-L-14.pt \
#   [CLIP_HF_PATH=/path/hf_clip_dir] \
#   knowledge_enhanced_multimodal_retrieval_tpu_torch/scripts/real_parity.sh <dataset-name-or-local-dir> [extra --flags]
#
# Smoke test (no artifacts needed):
#   knowledge_enhanced_multimodal_retrieval_tpu_torch/scripts/real_parity.sh --dry-run [--device=cpu]
set -euo pipefail
cd "$(dirname "$0")/../.."

DATASET="${1:-}"
shift || true
ARGS=()
if [ "$DATASET" = "--dry-run" ]; then
  ARGS+=(--dry-run)
elif [ -n "$DATASET" ]; then
  ARGS+=("--data.dataset=$DATASET")
fi

OUT=(--out PARITY_RESULTS.json)
for a in "$@"; do
  case "$a" in --out|--out=*) OUT=() ;; esac  # the caller's report path instead
done

exec python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.parity \
  "${OUT[@]}" "${ARGS[@]}" "$@"
