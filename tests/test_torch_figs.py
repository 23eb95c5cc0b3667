"""The paper-figure benchmarks computed through the port, on the CPU.

Each of ``benchmarks/fig08``-``fig17`` and ``benchmarks/trace_replay.py``
is loaded twice: as it stands (the reference) and as its port twin, its
source with every ``repro.`` import pointed at ``repro_torch.`` and
``benchmarks.common`` at a twin built the same way. The twin's ``run()``
rows must equal the reference's exactly: names, values and derived
strings. The benchmarks' files are not changed.

``trace_replay`` also serves its workloads through the engine: its twin
serves them through the port's engine on the CPU, on the reference's
weights (``init_params`` of the reference in this process, carried across
by ``from_jax_tree``), so that both record the same trace."""
import functools
import importlib
import re
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_arch as ref_arch
from repro.models import transformer as RT
from repro.models.params import init_params as ref_init_params
from repro_torch.models.params import from_jax_tree
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
COMMON = "_port_twin_benchmarks_common"
FIGS = ("fig08_gpt2_latency", "fig09_dfx", "fig10_breakdown",
        "fig11_energy", "fig12_adaptive", "fig13_unified", "fig14_bert",
        "fig15_sensitivity", "fig17_scaling")


def _port_source(src: str) -> str:
    src = re.sub(r"\bfrom repro\.", "from repro_torch.", src)
    assert "import repro" not in src.replace("import repro_torch", "")
    return src.replace("from benchmarks.common import",
                       f"from {COMMON} import")


def _load(name: str, path: Path) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    exec(compile(_port_source(path.read_text()), str(path), "exec"),
         mod.__dict__)
    return mod


def port_twin(name: str) -> types.ModuleType:
    """``benchmarks/<name>.py`` with its imports pointed at the port."""
    if COMMON not in sys.modules:
        sys.modules[COMMON] = _load(COMMON, BENCH / "common.py")
    return _load(f"_port_twin_{name}", BENCH / f"{name}.py")


def assert_no_reference(twin: types.ModuleType) -> None:
    """Nothing the twin's code reaches comes from the reference."""
    for v in list(vars(twin).values()) + list(
            vars(sys.modules[COMMON]).values()):
        mod = v.__name__ if isinstance(v, types.ModuleType) \
            else getattr(v, "__module__", None) or ""
        assert mod != "repro" and not mod.startswith("repro."), v


def reference(name: str) -> types.ModuleType:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


@pytest.mark.parametrize("name", FIGS)
def test_figure_rows_through_the_port_equal_the_reference(name):
    twin = port_twin(name)
    assert_no_reference(twin)
    want = reference(name).run()
    got = twin.run()
    assert len(got) == len(want) > 0
    assert got == want


def test_trace_replay_rows_through_the_port_equal_the_reference():
    """Both workloads served, lowered at full llama3.2-1b dims and
    replayed on IANUS and NPU-MEM: every breakdown row and the serve's
    dispatch and host-sync counts equal the reference's."""
    twin = port_twin("trace_replay")
    assert_no_reference(twin)

    def init_params(_defs, key):
        p = ref_init_params(RT.param_defs(ref_arch("llama3.2-1b").reduced()),
                            key)
        return from_jax_tree(jax.tree.map(np.asarray, p))
    twin.init_params = init_params
    twin.ServeEngine = functools.partial(ServeEngine, device="cpu")
    want = reference("trace_replay").run()
    got = twin.run()
    assert len(got) == len(want) == 14
    assert got == want
