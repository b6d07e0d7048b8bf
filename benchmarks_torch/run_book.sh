#!/bin/bash
# The BER book of the PyTorch + CUDA port on the card, from the root of the
# repository: the 18 curves, the 14 tail anchors, the deep points again to
# 100 frame errors (the points where the JAX book holds more than 3,000,000
# frames, each at its curve's batch), the book against the JAX book, the
# four spot checks and the air bench.  Writes benchmarks_torch/; the logs
# and a copy of benchmarks_torch/ go to $1 (default bench_results/book).
#
#     bash benchmarks_torch/run_book.sh [LOG_DIR]
O=${1:-bench_results/book}
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
M=ldpcgputegra_tpu_torch.bench
S=$SECONDS; python -m $M.ber_curves > "$O/curves.log" 2>&1
echo "curves rc $? $((SECONDS - S)) s"
grep -a "PERF\|Error" "$O/curves.log"
S=$SECONDS; python -m $M.ber_tail > "$O/tail.log" 2>&1
echo "tail rc $? $((SECONDS - S)) s"
grep -a "PERF\|EE\|Error" "$O/tail.log" | cut -c1-160
topup() {
    S=$SECONDS; python -m $M.ber_topup "$@" >> "$O/topup.log" 2>&1
    echo "topup $* rc $? $((SECONDS - S)) s"
}
topup --curve 1944x972_OMS_10 --snr 2.5 --snr 2.75 --batch 8192
topup --curve 2048x384_OMS_10 --snr 4.5 --batch 2048
topup --curve 4000x2000_OMS_10 --snr 2.25 --snr 2.5 --batch 4096
topup --curve 576x288_2NMS_10 --snr 3.5 --batch 16384
topup --curve 576x288_OMS_10 --snr 3.5 --batch 16384
topup --curve 8000x4000_OMS_10 --snr 2.25 --batch 2048
grep -a "(II)\|Error" "$O/topup.log"
python -m $M.ber_check --book > "$O/book.log" 2>&1
echo "book rc $?"
tail -n 3 "$O/book.log"
python -m $M.ber_check > "$O/spots.log" 2>&1
echo "spots rc $?"
grep -a "SPOT" "$O/spots.log" | cut -c1-400
S=$SECONDS; python -m $M.air > "$O/air.log" 2>&1
echo "air rc $? $((SECONDS - S)) s"
grep -a "(II)\|Error" "$O/air.log" | cut -c1-300
cp -r benchmarks_torch "$O/"
