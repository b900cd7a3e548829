"""The benchmark of software_renderer_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout. Prints the cell's metrics as the last
line of standard output (one JSON object) and the numbers its check
compared, each beside its limit, as the last lines of standard error.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(Path(__file__).resolve().parent)]

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
