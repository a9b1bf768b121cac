"""repro_torch, chip_smoke.py and algo1_ab.py must run on a CUDA host without JAX:
they import neither ``jax`` nor anything of ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the parity files import both; this one checks the port alone)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    """Every module named by an import statement, or by a string passed to
    importlib.import_module / __import__, in one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "algo1_ab.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core.federation, repro_torch.weights\n"
        "import repro_torch.kernels.grad_diff_norm.ops, repro_torch.kernels.topk_quant.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.linear_scan.ops\n"
        "import repro_torch.launch.serve, repro_torch.models.decoder\n"
        "from repro_torch.models.registry import get_smoke_config\n"
        "assert get_smoke_config('rwkv6_3b').name == 'rwkv6_3b_smoke'\n"
        "import repro_torch.algorithms.builtin, repro_torch.compress\n"
        "from repro_torch.core.runtimes import run_event_driven, run_round_based\n"
        "import repro_torch.core.runtimes.sync, repro_torch.core.scheduler\n"
        "import repro_torch.sim, repro_torch.sim.registry, repro_torch.common.fp32\n"
        "from repro_torch.sim import get_scenario\n"
        "assert get_scenario('mobile_fleet').build(3, 0)[1].active\n"
        "from repro_torch.algorithms import get_algorithm\n"
        "assert get_algorithm('vafl').name == 'vafl'\n"
        "assert get_algorithm('fedasync').name == 'fedasync'\n"
        "import repro_torch.core.runtimes.batched, repro_torch.compress.quantize\n"
        "import repro_torch.bench.fl_common, repro_torch.bench.table3_ccr\n"
        "from repro_torch.compress import get_codec\n"
        "assert get_codec('int4').name == 'int4'\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.store\n"
        "import repro_torch.obs, repro_torch.obs.live, repro_torch.obs.observer\n"
        "from repro_torch.obs import Observer, ObsConfig\n"
        "Observer(ObsConfig()).finish()\n"
        "import repro_torch.serve, repro_torch.serve.server, repro_torch.serve.client\n"
        "import repro_torch.serve.run, repro_torch.serve.multitenant\n"
        "import repro_torch.resilience, repro_torch.core.server\n"
        "import repro_torch.bench.fig4_convergence, repro_torch.bench.fig5_clients\n"
        "import repro_torch.bench.ablation_value\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.fl_mnist_vafl\n"
        "from repro_torch.serve import available_transports, get_transport\n"
        "assert available_transports() == ('inproc',)\n"
        "from repro_torch.core import ALGORITHMS\n"
        "assert 'vafl' in ALGORITHMS\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
