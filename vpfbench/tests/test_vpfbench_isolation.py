"""Nothing the benchmark loads brings in JAX or the JAX package, and the
reference loads nothing of the port. Each check runs in a fresh
interpreter, so the test process's own imports do not count."""

import json
import subprocess
import sys

from vpfbench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from vpfbench import harness
import vpfbench.run, vpfbench.control
bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
for w in bench["workloads"]:
    harness.load_cell(w["name"])
import videoprocessingframework_torch.serving
import videoprocessingframework_torch.io.pool
import videoprocessingframework_torch.ops.fused
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import vpfbench.reference.preprocess, vpfbench.reference.lowp
from vpfbench import harness
for p in (harness.HERE / "reference").glob("*.py"):
    harness.load_module(p, "reference")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_the_harness_or_the_port():
    tops = _tops(PROBE)
    assert "vpfbench" in tops and "videoprocessingframework_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    tops = _tops(REFERENCE)
    assert "videoprocessingframework_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)
