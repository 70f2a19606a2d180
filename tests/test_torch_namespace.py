"""The port's package namespaces against the JAX package's.

Every name of ``simpledsp_tpu``, ``simpledsp_tpu.design``,
``simpledsp_tpu.kernels``, ``simpledsp_tpu.models`` and
``simpledsp_tpu.parallel`` resolves in the port's counterpart, to the very
object its submodule defines, and is listed by ``dir()`` and ``__all__``.
The names resolve lazily: importing the port, in a process where any
import of jax fails, imports none of its submodules until a name is
touched.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

import simpledsp_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("", ".design", ".kernels", ".models", ".parallel")
NOT_YET = set()


def _jax_exports(sub: str) -> dict:
    """name: the port's module of it, read from the JAX package's
    ``__init__.py`` (its imports, without importing it)."""
    path = REPO / "simpledsp_tpu" / sub.strip(".").replace(".", "/") \
        / "__init__.py"
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                out[alias.asname or alias.name] = node.module.replace(
                    "simpledsp_tpu", "simpledsp_tpu_torch", 1)
    return out


def _cases():
    return [(sub, name, mod) for sub in PACKAGES
            for name, mod in sorted(_jax_exports(sub).items())]


def test_the_jax_namespaces_have_the_counts_the_port_mirrors():
    counts = [len(_jax_exports(sub)) for sub in PACKAGES]
    assert counts == [221, 41, 3, 15, 14]


@pytest.mark.parametrize("sub,name,mod", _cases(),
                         ids=[f"{s or 'top'}:{n}" for s, n, _ in _cases()])
def test_every_jax_name_resolves_to_its_submodules_object(sub, name, mod):
    import importlib
    pkg = importlib.import_module(f"simpledsp_tpu_torch{sub}")
    if name in NOT_YET:
        assert name not in pkg.__all__
        with pytest.raises(AttributeError):
            getattr(pkg, name)
        return
    assert getattr(pkg, name) is getattr(importlib.import_module(mod), name)
    assert name in pkg.__all__ and name in dir(pkg)


@pytest.mark.parametrize("sub", PACKAGES)
def test_all_is_the_jax_names_and_no_more(sub):
    import importlib
    pkg = importlib.import_module(f"simpledsp_tpu_torch{sub}")
    assert set(pkg.__all__) == set(_jax_exports(sub)) - NOT_YET
    assert len(pkg.__all__) == len(set(pkg.__all__))


def test_version_and_unknown_names():
    assert simpledsp_tpu_torch.__version__ == "0.1.0"
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        simpledsp_tpu_torch.nope
    from simpledsp_tpu_torch import models
    from simpledsp_tpu_torch.models import northstar
    assert models.ShardedNorthStarChain is northstar.ShardedNorthStarChain
    # A submodule still imports by its name through the lazy namespace.
    from simpledsp_tpu_torch.kernels import _build, fft
    assert fft.pallas_fft_supported is fft.fft_split_supported
    assert _build.__name__ == "simpledsp_tpu_torch.kernels._build"


def test_kernels_keep_the_jax_alias():
    from simpledsp_tpu_torch import kernels
    from simpledsp_tpu_torch.kernels import fft
    assert kernels.pallas_fft_supported is fft.fft_split_supported
    assert kernels.pallas_fft_supported(4096) and not \
        kernels.pallas_fft_supported(32768)


def test_names_resolve_lazily_without_jax():
    """Importing the port and its subpackages imports no ops, models or
    kernels module; touching one name imports its module and no other of
    those; then every name resolves, with jax made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simpledsp_tpu'] = None\n"
        "import simpledsp_tpu_torch as t\n"
        "import simpledsp_tpu_torch.design as d\n"
        "import simpledsp_tpu_torch.kernels as k\n"
        "import simpledsp_tpu_torch.models as m\n"
        "heavy = ('simpledsp_tpu_torch.ops', 'simpledsp_tpu_torch.models.',\n"
        "         'simpledsp_tpu_torch.kernels.', 'simpledsp_tpu_torch.design.')\n"
        "def loaded():\n"
        "    return sorted(n for n in sys.modules if n.startswith(heavy))\n"
        "assert loaded() == [], loaded()\n"
        "assert 'savgol_filter' in dir(t) and 'mfcc' in dir(m)\n"
        "assert loaded() == [], loaded()\n"
        "t.find_peaks\n"
        "assert loaded() == ['simpledsp_tpu_torch.ops',\n"
        "                    'simpledsp_tpu_torch.ops.peaks'], loaded()\n"
        "for ns in (t, d, k, m):\n"
        "    for name in ns.__all__:\n"
        "        getattr(ns, name)\n"
        "bad = [n for n, mod in sys.modules.items() if mod is not None\n"
        "       and (n in ('jax', 'simpledsp_tpu')\n"
        "            or n.startswith(('jax.', 'simpledsp_tpu.')))]\n"
        "assert not bad, bad\n"
        "print(len(t.__all__), len(d.__all__), len(k.__all__),\n"
        "      len(m.__all__))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["221", "41", "3", "15"]
