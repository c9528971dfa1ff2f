"""The port stands alone: importing every module of ``seqalign_torch``,
and ``chip_smoke.py``'s imports, loads neither JAX nor ``seqalign_tpu``
and launches no kernel.  Checked in a fresh interpreter,
because this test process has JAX loaded already (conftest).  And the
kernels' libraries are digested over every header their sources
include."""

import glob
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import seqalign_torch
modules = sorted(
    info.name for info in pkgutil.walk_packages(
        seqalign_torch.__path__, "seqalign_torch.")
)
for name in modules:
    importlib.import_module(name)
import chip_smoke  # runs nothing: its work is under the __main__ check
from seqalign_torch.ops import (batch_fill, batch_traceback, strip_fill,
                                walk, wavefront)
from seqalign_torch.probes import dpx16, walk_costs
foreign = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "seqalign_tpu")
)
print(json.dumps({
    "modules": modules,
    "foreign": foreign,
    "launches": [wavefront.wavefront_strip.launches,
                 walk.walk_skewed_window.launches,
                 batch_fill.batch_score.launches,
                 batch_fill.batch_fill_dirs.launches,
                 batch_fill.batch_score.cell16_launches,
                 batch_fill.batch_fill_dirs.cell16_launches,
                 batch_traceback.batch_walk.launches,
                 batch_traceback.walk_packed.launches,
                 strip_fill.strip_fill.launches,
                 dpx16.apply.launches, dpx16.rate_launch.launches,
                 walk_costs.chase.launches],
}))
"""


def _probe(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_launches_nothing(tmp_path):
    got = _probe(tmp_path)
    for name in ("seqalign_torch.ops.wavefront", "seqalign_torch.ops.walk",
                 "seqalign_torch.ops.direct", "seqalign_torch.cli",
                 "seqalign_torch.models.base", "seqalign_torch.ops._build",
                 "seqalign_torch.ops.checkpoint",
                 "seqalign_torch.ops.traceback",
                 "seqalign_torch.ops.batch_fill",
                 "seqalign_torch.ops.batch_traceback",
                 "seqalign_torch.parallel", "seqalign_torch.parallel.batch",
                 "seqalign_torch.parallel.mesh",
                 "seqalign_torch.parallel.sequence",
                 "seqalign_torch.parallel.dryrun",
                 "seqalign_torch.parallel.worker",
                 "seqalign_torch.ops.strip_fill", "seqalign_torch.ops.tiled",
                 "seqalign_torch.probes", "seqalign_torch.probes.dpx16",
                 "seqalign_torch.probes.walk_costs",
                 "seqalign_torch.probes.batch_walk_shapes",
                 "seqalign_torch.bench", "seqalign_torch.bench.timing",
                 "seqalign_torch.bench.suite"):
        assert name in got["modules"]
    assert got["foreign"] == []
    assert got["launches"] == [0] * 12


def test_port_sources_name_no_jax():
    # No module of the port, and not chip_smoke.py, imports JAX or the
    # JAX package, even lazily inside a function.
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "seqalign_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for number, line in enumerate(f, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in ("jax", "jaxlib", "seqalign_tpu"), (
                        f"{path}:{number}: {line.strip()}")


def test_every_included_header_is_digested():
    # A header missing from _build.HEADERS leaves a stale cached library
    # after it changes, with no error: every quoted #include of a source
    # or header names one of HEADERS, and each of HEADERS exists.
    from seqalign_torch.ops import _build

    names = {os.path.basename(path) for path in _build.HEADERS}
    sources = sorted(glob.glob(os.path.join(_build.CSRC, "*.cu")) +
                     glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    assert sources
    included = set()
    for path in sources:
        with open(path) as f:
            for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                                   f.read(), re.M):
                assert name in names, f"{path} includes {name}"
                included.add(name)
    assert "interpair_host.cuh" in included
    for path in _build.HEADERS:
        assert os.path.isfile(path), path
