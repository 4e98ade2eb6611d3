"""The port imports on its own: every ``repro_torch`` module (and
``chip_smoke.py``) imports in a fresh interpreter whose import system
refuses ``jax``, the JAX package ``repro`` and ``triton``."""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "repro", "triton")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(" ".join(names))
    print(len(names))
""")


def test_every_module_imports_without_jax_repro_or_triton():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           ROOT]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # the port's package, its subpackages and modules all walked
    lines = out.stdout.strip().splitlines()
    assert int(lines[-1]) >= 25
    walked = set(lines[-2].split())
    assert {"repro_torch.search.fused", "repro_torch.dse",
            "repro_torch.dse.service", "repro_torch.dse.islands"} <= walked
