"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``afford_motion_tpu`` anywhere under ``perfbench/``,
and nothing of the program (``afford_motion_torch``) in the reference.
Each check runs in a fresh interpreter and compares whole top-level names."""
import json
import subprocess
import sys

from .conftest import ROOT

CHECK = """
import importlib, importlib.util, json, pathlib, sys
sys.path.insert(0, {root!r})
for path in {paths!r}:
    rel = pathlib.Path(path).relative_to({root!r})
    if (pathlib.Path(path).parent / "__init__.py").exists():  # a module of a package
        importlib.import_module(".".join(rel.with_suffix("").parts))
    else:  # a file found by its name
        spec = importlib.util.spec_from_file_location("m" + str(abs(hash(path))), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def loaded_top_names(paths):
    out = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT), paths=paths)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def files(sub):
    return [str(p) for p in sorted((ROOT / "perfbench" / sub).rglob("*.py"))]


def test_nothing_under_perfbench_loads_jax():
    paths = [str(p) for p in sorted((ROOT / "perfbench").rglob("*.py"))
             if "tests" not in p.parts and p.name != "run.py"]
    names = loaded_top_names(paths)
    assert not names & {"jax", "jaxlib", "flax", "afford_motion_tpu"}, names


def test_a_run_loads_no_jax(small, capsys):
    from perfbench.harness import core

    from .conftest import run_cell

    rc, result, err = run_cell("cdm_perceiver_h3d.train_store", small(), capsys)
    assert rc == 0 and result is not None, err[-2000:]
    assert not set(core.forbidden_loaded())


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_top_names(files("reference"))
    assert "afford_motion_torch" not in names and "afford_motion_tpu" not in names, names


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "cmdm_enc_h3d.train_store", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
