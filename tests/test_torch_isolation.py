"""The port stands alone: `repro_torch`, `chip_smoke.py` and the
port-side examples (`examples/torch_*.py`) import neither JAX nor
anything of the reference package `repro`.

Checked twice: by importing every module of the port (and the smoke
script) in a fresh interpreter and looking at `sys.modules`, and by
searching the sources for import lines, which also covers imports
made inside functions.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)"
    r"|from\s+(jax|jaxlib|repro)\b(?!_))", re.MULTILINE)

PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
for path in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location(
        "example_" + path.rsplit("/", 1)[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "forbidden": bad}))
"""


def test_modules_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE, str(ROOT),
                           *map(str, EXAMPLES)],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert {module_name(p) for p in PORT.rglob("*.py")} == \
        set(got["imported"])


def module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(PORT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_have_no_forbidden_import(path):
    text = path.read_text()
    assert not FORBIDDEN.findall(text), path


def test_port_examples_are_scanned():
    assert {p.name for p in EXAMPLES} == {
        "torch_serve_two_tier.py", "torch_quickstart.py",
        "torch_placement_study.py"}


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import lax", "    from repro.kernels import ref",
                 "import repro", "from repro import configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch import bridge",
                 "# the reference imports jax", "import numpy"):
        assert not FORBIDDEN.search(line), line
