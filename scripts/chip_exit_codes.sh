#!/bin/sh
# Run the port's on-card checks from a checkout and record each command's
# exit code:
#   1. python3 chip_smoke.py from the checkout's root;
#   2. the card-only tests (tests/test_torch_card.py, without the
#      repository's conftest, which imports the JAX package);
#   3. chip_smoke.py copied alone into an empty directory, where it must
#      fail (no src/repro_torch beside it) and print no result.
#
# Usage (on the card's machine, from the repository's root):
#   sh scripts/chip_exit_codes.sh [CHECKOUT [LOGDIR]]
# CHECKOUT defaults to the current directory; a `git archive` unpacked under
# build/ checks that the committed files alone suffice.  Each command's full
# output goes to LOGDIR/<name>.log (default build/chip_logs); the summary
# lines end the output.
set -u
here=$(pwd)
src=$(cd "${1:-.}" && pwd)
mkdir -p "${2:-build/chip_logs}"
out=$(cd "${2:-build/chip_logs}" && pwd)
alone=$(mktemp -d "$here/build/chip_smoke_alone.XXXXXX" 2>/dev/null || mktemp -d)

cd "$src"
start=$(date +%s)
python3 chip_smoke.py > "$out/chip_smoke.log" 2>&1
rc_smoke=$?
t_smoke=$(( $(date +%s) - start ))

start=$(date +%s)
PYTHONPATH=src python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_card.py \
    > "$out/card_tests.log" 2>&1
rc_card=$?
t_card=$(( $(date +%s) - start ))

cp chip_smoke.py "$alone/"
cd "$alone"
python3 chip_smoke.py > "$out/chip_smoke_alone.log" 2>&1
rc_alone=$?
cd "$here"
rm -rf "$alone"

echo "--- chip_smoke.py: last lines"
tail -n 4 "$out/chip_smoke.log"
echo "--- card tests: last line"
tail -n 1 "$out/card_tests.log"
echo "--- chip_smoke.py alone: output"
cat "$out/chip_smoke_alone.log"
echo "exit codes: chip_smoke.py $rc_smoke (${t_smoke} s), card tests $rc_card (${t_card} s)," \
     "chip_smoke.py alone $rc_alone"
