"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, and its
registries fail fast with the available names."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.api import registry
from repro_torch.core import pipeline as tpipe

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_SUB_ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
for _k in ("JAX_PLATFORMS", "XLA_FLAGS", "HOME"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
assert not leaked, leaked
assert sys.modules["jax"] is None
print(len(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.strip())
    assert n_modules == len(list(PORT.rglob("*.py"))) - 1  # minus __init__


def test_the_scan_paths_import_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch.models.rwkv6, repro_torch.models.mamba2\n"
            "import repro_torch.kernels.rwkv6_scan.ops\n"
            "import repro_torch.kernels.mamba2_ssd.ops\n"
            "assert sys.modules['jax'] is None\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_zoo_paths_import_without_jax():
    """The MoE/MLA, VLM and encoder-decoder families: their modules, their
    configs and a smoke forward of each, with JAX blocked."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch\n"
            "import repro_torch.models.mla, repro_torch.models.moe\n"
            "import repro_torch.models.deepseek, repro_torch.models.vision\n"
            "import repro_torch.models.encdec\n"
            "from repro_torch.configs import get_smoke_config\n"
            "from repro_torch.models import build_model\n"
            "for arch in ('deepseek-v2-lite-16b', 'deepseek-v3-671b',\n"
            "             'llama-3.2-vision-11b', 'seamless-m4t-large-v2'):\n"
            "    cfg = get_smoke_config(arch)\n"
            "    m = build_model(cfg, device='cpu')\n"
            "    p = m.init(torch.Generator().manual_seed(0))\n"
            "    b = {'tokens': torch.zeros(1, 8, dtype=torch.int32),\n"
            "         'img_embed': torch.zeros(1, 4, cfg.d_model),\n"
            "         'src_embed': torch.zeros(1, 16, cfg.d_model)}\n"
            "    assert m.forward(p, b).shape == (1, 8, cfg.vocab)\n"
            "assert sys.modules['jax'] is None\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import api
    from repro_torch.api import EPICCompressor
    from repro_torch.data import synthetic

    with pytest.raises(RuntimeError, match="device='cpu'"):
        EPICCompressor(tpipe.EPICConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.generate_stream(None, synthetic.StreamConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.compress_stream(None, None, None, tpipe.EPICConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.get_compressor("fv")(api.BaselineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.depth_training_batch(None, synthetic.StreamConfig(), 4)


def test_default_backend_is_the_kernel():
    assert tpipe.EPICConfig().backend == "fused"
    assert tpipe.EPICConfig().tsrc_config().backend == "fused"


@pytest.mark.parametrize(
    "lookup,what",
    [
        (registry.get_backend, "kernel backend"),
        (registry.get_stage, "frame stage"),
        (registry.get_compressor, "compressor"),
        (registry.get_combinator, "combinator"),
    ],
)
def test_unknown_keys_list_the_available_names(lookup, what):
    with pytest.raises(KeyError) as exc:
        lookup("bogus")
    msg = str(exc.value)
    assert f"unknown {what} 'bogus'" in msg
    for name in {
        "kernel backend": ("fused", "pallas", "pallas_tiled", "ref"),
        "frame stage": ("bypass", "depth", "saliency", "tsrc", "retain",
                        "select.fv", "select.sd", "select.td", "select.gc"),
        "compressor": ("epic", "fv", "sd", "td", "gc"),
        "combinator": ("gated",),
    }[what]:
        assert repr(name) in msg


def test_config_validation_fails_fast():
    with pytest.raises(KeyError, match="pallas_tiled"):
        tpipe.EPICConfig(backend="bogus")
    with pytest.raises(KeyError):
        tpipe.EPICConfig()._replace(backend="bogus")
    with pytest.raises(ValueError):
        tpipe.EPICConfig(prefilter_k=-1)
    with pytest.raises(TypeError):
        tpipe.EPICConfig(patch_k=1.5)
    from repro_torch.api import EPICCompressor

    with pytest.raises(ValueError, match="strictly increasing"):
        EPICCompressor(tpipe.EPICConfig(), device="cpu", k_ladder=(16, 8))
    with pytest.raises(ValueError, match="not a rung"):
        EPICCompressor(tpipe.EPICConfig(prefilter_k=4), device="cpu",
                       k_ladder=(8, 16))


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    """``chip_smoke.py`` fails, and prints no result, without a CUDA card
    and when it stands alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], env=_SUB_ENV, cwd=cwd,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_serve_names_resolve_lazily_without_jax():
    """``repro_torch.serve`` maps every name of the reference's ``_LAZY``
    table, the checkpoint ones included, to its module; importing the
    package loads none of them, and nothing imports JAX.
    ``repro_torch.obs`` and ``repro_torch.api.StreamPool`` likewise."""
    code = ("import importlib, re, sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch, repro_torch.serve as s\n"
            "assert 'repro_torch.serve.efm' not in sys.modules\n"
            "assert 'repro_torch.serve.server' not in sys.modules\n"
            "ref = open('src/repro/serve/__init__.py').read()\n"
            "names = re.findall(r'\"(\\w+)\": \"repro\\.serve\\.(\\w+)\"', ref)\n"
            "want = sorted(n for n, m in names)\n"
            "assert sorted(s.__all__) == want, sorted(s.__all__)\n"
            "for name in want:\n"
            "    mod = importlib.import_module(s._LAZY[name])\n"
            "    assert getattr(s, name) is getattr(mod, name), name\n"
            "import repro_torch.obs as o\n"
            "from repro_torch.obs.metrics import MetricsRegistry\n"
            "assert o.MetricsRegistry is MetricsRegistry\n"
            "for name in o.__all__:\n"
            "    getattr(o, name)\n"
            "from repro_torch.api import StreamPool\n"
            "from repro_torch.api.pool import StreamPool as P\n"
            "assert StreamPool is P\n"
            "for mod in (s, o):\n"
            "    try:\n"
            "        mod.bogus\n"
            "    except AttributeError:\n"
            "        pass\n"
            "    else:\n"
            "        raise AssertionError('bogus resolved')\n"
            "assert sys.modules['jax'] is None\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_serve_lazy_table_is_the_references_where_ported():
    """Every name of the port's table is in the reference's, under the
    same module (``repro.serve.X`` -> ``repro_torch.serve.X``)."""
    import re

    from repro_torch import serve

    ref = (ROOT / "src" / "repro" / "serve" / "__init__.py").read_text()
    ref_lazy = dict(re.findall(r'"(\w+)": "repro\.serve\.(\w+)"', ref))
    for name, mod in serve._LAZY.items():
        assert mod == f"repro_torch.serve.{ref_lazy[name]}", name


_NEW_MODULES = (
    "repro_torch.wire", "repro_torch.wire.codec", "repro_torch.wire.server",
    "repro_torch.wire.trace", "repro_torch.wire.loadgen",
    "repro_torch.wire.latency", "repro_torch.wire.fault",
    "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.runtime", "repro_torch.runtime.fault",
    "repro_torch.obs.status", "repro_torch.obs.dump",
    "repro_torch.serve.checkpoint", "repro_torch.core.evu",
)


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_wire_checkpoint_runtime_and_evu_import_without_jax(module):
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"importlib.import_module({module!r})\n"
            "assert sys.modules['jax'] is None\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_wire_lazy_table_is_the_references_and_resolves():
    """``repro_torch.wire`` maps every name of the reference's table to the
    same module of the port; each resolves, and importing the package
    loads neither the server nor the serving stack."""
    import re

    ref = (ROOT / "src" / "repro" / "wire" / "__init__.py").read_text()
    ref_lazy = dict(re.findall(r'"(\w+)": "repro\.wire\.(\w+)"', ref))
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch.wire as w\n"
            "assert 'repro_torch.wire.server' not in sys.modules\n"
            "assert 'repro_torch.serve.server' not in sys.modules\n"
            "for name in w.__all__:\n"
            "    mod = importlib.import_module(w._LAZY[name])\n"
            "    assert getattr(w, name) is getattr(mod, name), name\n"
            "try:\n"
            "    w.bogus\n"
            "except AttributeError:\n"
            "    pass\n"
            "else:\n"
            "    raise AssertionError('bogus resolved')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    from repro_torch import wire

    assert {n: m.rsplit(".", 1)[1] for n, m in wire._LAZY.items()} \
        == ref_lazy


def test_the_launch_layer_imports_without_jax():
    """The mesh and distribution layer: every ``repro_torch.launch``
    module, with JAX blocked."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
            "import repro_torch.launch.compression\n"
            "import repro_torch.launch.collectives\n"
            "import repro_torch.launch.serve, repro_torch.launch.train\n"
            "import repro_torch.launch.train_efm\n"
            "assert sys.modules['jax'] is None\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_the_dry_run_imports_without_jax():
    """``launch.dryrun`` and ``launch.hloparse`` (the reference's set
    ``XLA_FLAGS`` and import JAX): neither imports JAX or the JAX
    package, and importing the dry-run touches no process group."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hloparse\n"
            "assert sys.modules['jax'] is None\n"
            "assert not dist.is_initialized()\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], env=_SUB_ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
