"""The port's native IO tier on a fresh tree: processes that start at once
build ``libccst_io.so`` once, under a file lock, and every one of them loads
a whole library (``ccst_tpu_torch/native/__init__.py``)."""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "ccst_tpu_torch", "native")

# load the copied package from its own directory and report what it found
LOADER = textwrap.dedent("""
    import importlib.util, sys
    spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    print("available" if mod.available() else "unavailable")
""")


def _fresh_copy(tmp_path):
    """The sources of the native tier in a directory of their own, unbuilt."""
    dst = tmp_path / "native"
    dst.mkdir()
    for name in ("__init__.py", "Makefile", "ccst_io.cpp"):
        shutil.copy(os.path.join(NATIVE, name), dst / name)
    return dst


@pytest.mark.parametrize("procs", [2, 4])
def test_processes_that_start_together_all_load_one_build(tmp_path, procs):
    if shutil.which("make") is None:
        pytest.skip("no make: the native IO library cannot be built here")
    dst = _fresh_copy(tmp_path)
    runs = [subprocess.Popen([sys.executable, "-c", LOADER, str(dst / "__init__.py")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _ in range(procs)]
    said = [r.communicate(timeout=300)[0].strip() for r in runs]
    if all(s == "unavailable" for s in said) and not (dst / "libccst_io.so").exists():
        pytest.skip("the toolchain here cannot build the native IO library")
    assert said == ["available"] * procs
    # one library, no build left half done beside it
    leftovers = sorted(p.name for p in dst.iterdir() if p.name.endswith(".tmp"))
    assert leftovers == [] and (dst / "libccst_io.so").exists()


def test_a_built_library_is_loaded_without_a_rebuild(tmp_path):
    if shutil.which("make") is None:
        pytest.skip("no make: the native IO library cannot be built here")
    dst = _fresh_copy(tmp_path)
    first = subprocess.run([sys.executable, "-c", LOADER, str(dst / "__init__.py")],
                           capture_output=True, text=True, timeout=300).stdout.strip()
    if first != "available":
        pytest.skip("the toolchain here cannot build the native IO library")
    stamp = os.stat(dst / "libccst_io.so").st_mtime_ns
    again = subprocess.run([sys.executable, "-c", LOADER, str(dst / "__init__.py")],
                           capture_output=True, text=True, timeout=300).stdout.strip()
    assert again == "available" and os.stat(dst / "libccst_io.so").st_mtime_ns == stamp
