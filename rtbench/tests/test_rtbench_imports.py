"""What the benchmark loads: nothing of JAX, of the JAX package or of the
old `benchmarks/` folder anywhere, and nothing of the port in the
reference."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from rtbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "zig_vulkan_tpu", "benchmarks"}
REF = spec.PACKAGE / "ref"


def _loaded(code: str):
    """The top-level names of the modules a fresh interpreter holds after
    `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_nothing_forbidden():
    readers = "; ".join(f"spec.reader({m.name!r})"
                        for m in spec.metrics(spec.load(), "per_layer"))
    names = _loaded(
        "from rtbench import run, control, devtrace, spec, check, scene, "
        "traffic, roofline\n"
        "from rtbench.ref import engine\n"
        "import zig_vulkan_tpu_torch.engine.engine\n"
        "import zig_vulkan_tpu_torch.io.scene_io\n"
        "import zig_vulkan_tpu_torch.utils.profiling\n"
        "import torch.profiler\n" + readers + "\n" + _plugin_loads())
    assert not names & FORBIDDEN
    assert "zig_vulkan_tpu_torch" in names


PLUGINS = ("scenes", "references", "generators", "edits")


def _plugin_loads():
    """Code that loads every plug-in file of `PLUGINS`."""
    return "\n".join(
        f"spec.plugin({kind!r}, {p.stem!r})"
        for kind in PLUGINS for p in sorted((spec.PACKAGE / kind).glob(
            "*.py")))


def test_reference_loads_nothing_of_the_port():
    """The reference, and every plug-in that builds a scene, makes the
    traffic or stands in for the program: nothing of the port."""
    mods = sorted("rtbench.ref." + ".".join(p.relative_to(REF).with_suffix(
        "").parts) for p in REF.rglob("*.py") if p.name != "__init__.py")
    names = _loaded("\n".join(f"import {m}" for m in mods)
                    + "\nimport rtbench.check, rtbench.scene, "
                    "rtbench.traffic, rtbench.roofline\n"
                    "from rtbench import spec\n" + _plugin_loads())
    assert not names & (FORBIDDEN | {"zig_vulkan_tpu_torch"})


def test_reference_sources_import_only_themselves():
    """Every import in rtbench/ref is of the standard library, numpy,
    torch, or relative within rtbench/ref."""
    allowed = {"numpy", "torch", "dataclasses", "typing", "struct", "math",
               "__future__", "os", "sys", "zipfile", "ctypes"}
    for path in REF.rglob("*.py"):
        depth = len(path.relative_to(REF).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] in allowed, (path, a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    assert node.level <= depth + 1, (path, node.module)
                else:
                    assert node.module.split(".")[0] in allowed, (
                        path, node.module)


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and rtbench/ runs nothing."""
    import shutil

    shutil.copy(spec.BENCHMARK_FILE, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.PACKAGE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload",
         "default_flythrough", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload",
         "default_flythrough", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300, env={**__import__("os").environ,
                          "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
