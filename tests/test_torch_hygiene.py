"""The port stands alone: no JAX, nothing of ``repro``, and entry points
that run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.configs.scope_estimator import TINY

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports_in_the_port():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.io, "
            "repro_torch.kernels, repro_torch.serving.sampler, "
            "repro_torch.serving.kv_pool, repro_torch.serving.scheduler, "
            "repro_torch.serving.runtime, repro_torch.serving.faults, "
            "repro_torch.serving.engine, repro_torch.models.ssm, "
            "repro_torch.kernels.ssd_scan, repro_torch.configs.mamba2_1_3b, "
            "repro_torch.models.tier0, repro_torch.serving.feedback, "
            "repro_torch.training.optimizer, repro_torch.training.tier0, "
            "repro_torch.training.sft, repro_torch.training.grpo, "
            "repro_torch.training.checkpoint, repro_torch.data.pipeline, "
            "repro_torch.core.rewards, repro_torch.core.baselines, "
            "repro_torch.core.evaluation, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.launch.specs, "
            "repro_torch.launch.step_cost, repro_torch.launch.dryrun, "
            "repro_torch.distributed.sharding, repro_torch.launch.mesh, "
            "repro_torch.analysis, repro_torch.analysis.runtime_pass, "
            "repro_torch.analysis.selftest\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device()
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA, every entry point called without ``device`` raises
    instead of sliding onto the plain versions."""
    from repro_torch import io
    from repro_torch.core.fingerprint import AnchorSet
    from repro_torch.core.retrieval import AnchorRetriever
    from repro_torch.models import model as M
    from repro_torch.models import tier0 as T0
    from repro_torch.training import tier0 as T0train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(TINY, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnchorRetriever(AnchorSet([], torch.zeros(3, 4).numpy()))
    with pytest.raises(RuntimeError, match="CUDA"):
        io.params_from_numpy({}, TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        T0.init_tier0(torch.Generator())
    head = T0.init_tier0(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        io.tier0_params_from_numpy({k: v.numpy() for k, v in head.items()})
    with pytest.raises(RuntimeError, match="CUDA"):
        T0train.train_tier0({"q": torch.zeros(4).numpy()}, steps=1)
    from repro_torch.core.baselines import LinearSVMRouter, MLPRouter
    from repro_torch.data.pipeline import batches
    with pytest.raises(RuntimeError, match="CUDA"):
        next(batches({"tokens": torch.zeros(4, 2).numpy()}, 2))
    for router in (MLPRouter(steps=1), LinearSVMRouter(steps=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            router.fit(torch.zeros(4, 3).numpy(), torch.zeros(4).long()
                       .numpy(), 2)
    # under a process group too: the rank's card, or a raise without CUDA
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert device_mod.resolve_device() == torch.device("cuda:3")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    assert device_mod.resolve_device() == torch.device("cuda:0")


def test_resolve_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert device_mod.resolve_device("cuda:0").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_first_use_build_compiles_once_across_processes(tmp_path):
    """Two processes that build the same library at once run the compiler
    once: the second waits on the build directory's lock and finds the
    library (a stub compiler counts its runs)."""
    stub = tmp_path / "nvcc"
    runs = tmp_path / "runs"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo run >> {runs}\n"
        "sleep 1\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    stub.chmod(0o755)
    code = (
        "import sys; from pathlib import Path\n"
        "from repro_torch.kernels import build\n"
        f"build.BUILD_DIR = Path({str(tmp_path / 'out')!r})\n"
        f"build.NVCC_PATHS = ({str(stub)!r},)\n"
        "print(build.build(['topk_retrieval'])['topk_retrieval'])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and Path(outs[0]).read_text() == "lib\n"
    assert runs.read_text() == "run\n"
