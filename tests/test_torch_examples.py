"""The port's examples (``examples/pt_*.py``), each run with ``--device
cpu`` in a subprocess of its own, held to the JAX package's examples.

* ``pt_quickstart.py`` prints exactly what ``quickstart.py`` prints;
  ``pt_design_space_exploration.py`` and ``pt_sparsity_advisor.py`` the
  same numbers as theirs (engine, enumeration, vmapper, advisor), and
  ``pt_search_dse.py`` the same enumeration numbers.  The JAX examples
  run in one aliased subprocess (``torch_reference.run_reference``),
  their standard output captured.
* ES numbers differ with the random stream: only that they were found,
  that the trajectory never rises and that the winner was validated.
* Serving and training print their counts; each example imports only
  ``repro_torch`` and, without ``--device cpu``, asks for the card.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

import torch_reference as R

EXAMPLES = os.path.join(R.ROOT, "examples")
PORTED = ("quickstart", "design_space_exploration", "search_dse",
          "serve_lm", "sparsity_advisor", "train_lm")
#: the JAX examples whose printed numbers the port's are held to
COMPARED = ("quickstart", "design_space_exploration", "search_dse",
            "sparsity_advisor")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


@pytest.fixture(scope="module")
def reference():
    return R.run_reference(f"""
        import contextlib, io, runpy
        for name in {COMPARED!r}:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                runpy.run_path(f"examples/{{name}}.py", run_name="__main__")
            OUT[name] = buf.getvalue()
    """)


def _run(name: str, *args: str, check: bool = True):
    env = dict(os.environ, PYTHONPATH=os.path.join(R.ROOT, "src"),
               OMP_NUM_THREADS="4")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, f"pt_{name}.py"), *args],
        cwd=R.ROOT, env=env, capture_output=True, text=True, timeout=60)
    if check:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _port(name: str) -> str:
    return _run(name, "--device", "cpu").stdout


def test_quickstart_prints_the_reference(reference):
    assert _port("quickstart") == reference["quickstart"]


def test_design_space_exploration_numbers(reference):
    got, want = _port("design_space_exploration"), \
        reference["design_space_exploration"]
    assert NUMBER.findall(got) == NUMBER.findall(want)
    assert "one batched evaluation" in got


def _section(text: str, start: str, stop: str) -> str:
    return text[text.index(start):text.index(stop)]


def test_search_dse_enumeration_numbers_and_es_winners(reference):
    got, want = _port("search_dse"), reference["search_dse"]
    enum = re.compile(r"(density=\S+ \S+)\s+enum EDP=\s*(\S+)")
    assert enum.findall(got) == enum.findall(want) and len(
        enum.findall(got)) == 6
    es = [float(x) for x in re.findall(r"es EDP=\s*(\S+)", got)]
    assert len(es) == 6 and all(0 < x < float("inf") for x in es)
    traj = [float(x) for x in re.findall(r"best EDP=(\S+)\n", got)]
    assert len(traj) == 8 and traj == sorted(traj, reverse=True)
    assert "winning mapping (validated through the scalar oracle):" in got


def test_sparsity_advisor_tables_and_k3(reference):
    got, want = _port("sparsity_advisor"), reference["sparsity_advisor"]
    head, stop = "== Sparseloop TPU-v5e advisor ==", "\n== executing"
    assert _section(got, head, stop) == _section(want, head, stop)
    assert "with K3's plain PyTorch version (CPU)" in got
    assert "max|err| = 0.0000 (bf16)" in got
    assert "HBM weight bytes: 98304 vs dense 262144 (0.375x)" in got
    assert "K3 launches: 0" in got      # the CPU runs the plain version


def test_serve_lm_generates_every_token():
    assert "generated 160 tokens across 10 requests" in _port("serve_lm")


def test_train_lm_trains_and_resumes():
    out = _port("train_lm")
    assert "resumed from step 30" in out
    assert "(ran 10 additional steps)" in out
    first, last = map(float, re.search(
        r"first loss (\S+) -> last loss (\S+),", out).groups())
    assert last < first
    assert "K4 launches: 0" in out


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_only_the_port(name):
    with open(os.path.join(EXAMPLES, f"pt_{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
    assert any(m.startswith("repro_torch") for m in mods)


def test_examples_ask_for_the_card_by_default():
    """Without ``--device cpu`` an example runs on the card: here, with
    none, it stops naming ``device="cpu"``."""
    proc = _run("quickstart", check=False)
    assert proc.returncode != 0 and 'device="cpu"' in proc.stderr
