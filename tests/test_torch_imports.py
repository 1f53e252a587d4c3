"""The port loads no JAX: a fresh interpreter imports every module of
``hybrid_ctunet_tpu_torch`` (the training, data and CLI modules with them),
runs the TINY ensemble (CTUNet depth 50 and TUNet sliding-window inference,
softmax-mean, argmax, through cli/bench.py's functions) and one TINY TUNet
train step with its scalar log, then checks sys.modules. And every name the
benchmark's files import from the port exists in it (read from their
source, not imported)."""
import ast
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_threads import THREADS, two_threads  # noqa: F401 (autouse: two torch threads)

REPO = Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(f"""
    import importlib, pkgutil, sys
    import torch
    torch.set_num_threads({THREADS})
    import hybrid_ctunet_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    from hybrid_ctunet_tpu_torch.cli import bench

    tiny = dict(dtype=torch.float32, out_channels=3, dim_conv_stem=16, img_size=(32, 32),
                frames=32, hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
    tu = bench.make_engine(bench.build_tunet(0, "cpu", **tiny), roi=(32, 32, 32), sw=2)
    ct = bench.make_ctunet_engine(bench.build_ctunet(0, "cpu", model_depth=50, **tiny),
                                  roi=(32, 32, 32), sw=2)
    vol = bench.make_volume(0, (40, 36, 33), "cpu")
    res, logits, prob, mask = bench.segment_hybrid(ct, tu, vol)
    for t in (res, logits, prob):
        assert tuple(t.shape) == (1, 40, 36, 33, 3) and torch.isfinite(t).all(), t.shape
    assert tuple(mask.shape) == (1, 40, 36, 33) and 0 <= mask.min() and mask.max() < 3

    import tempfile
    from hybrid_ctunet_tpu_torch.train import state, steps
    from hybrid_ctunet_tpu_torch.utils.logging import ScalarWriter
    model = bench.build_tunet(0, "cpu", **tiny)
    step = steps.make_train_step("tunet", model, state.make_optimizer(model.parameters()))
    m = step(torch.randn(1, 32, 32, 32, 1), torch.randint(0, 3, (1, 32, 32, 32, 1)), 1e-4)
    assert torch.isfinite(m["loss"])
    with tempfile.TemporaryDirectory() as d:
        w = ScalarWriter(d)
        w.add_scalar("train_loss", m["loss"], 0)
        w.close()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    print(len(names), "modules;", "loaded:", loaded)
    assert not loaded, loaded
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded: []" in proc.stdout


# the benchmark's files that import the port
BENCHMARK_FILES = ("benchmark/drivers/ensemble.py", "benchmark/drivers/single.py",
                   "benchmark/drivers/train.py", "benchmark/metrics/step.host_ms.train.py")


@pytest.mark.parametrize("path", BENCHMARK_FILES)
def test_benchmark_imports_exist_in_the_port(path):
    tree = ast.parse((REPO / path).read_text(), path)
    imports = [(node.module, alias.name) for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom) and node.level == 0
               and node.module.split(".")[0] == "hybrid_ctunet_tpu_torch"
               for alias in node.names]
    assert imports, f"{path} imports nothing from the port"
    missing = []
    for module, name in imports:
        mod = importlib.import_module(module)
        if not hasattr(mod, name):
            try:
                importlib.import_module(f"{module}.{name}")
            except ModuleNotFoundError:
                missing.append(f"{module}.{name}")
    assert not missing, f"{path} imports names the port does not have: {missing}"
