"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see ``port_bench/harness.py``.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
