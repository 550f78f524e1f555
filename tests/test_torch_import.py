"""The port stands alone: ``hetu_tpu_torch``, ``chip_smoke.py`` and
``port_probe.py`` import neither jax nor ``hetu_tpu`` (nor
``safetensors``: the checkpoints' format is written and read in
``utils/checkpoint.py``), and no entry point falls back to the CPU by
itself."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hetu_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_jax_unloaded():
    mods = list(_modules())
    for m in ("hetu_tpu_torch.serving.engine", "hetu_tpu_torch.core.bits",
              "hetu_tpu_torch.core.dtypes", "hetu_tpu_torch.optim",
              "hetu_tpu_torch.parallel.strategy",
              "hetu_tpu_torch.engine.train_step",
              "hetu_tpu_torch.ops.quantization", "hetu_tpu_torch.ops.rotary",
              "hetu_tpu_torch.models.llama", "hetu_tpu_torch.data.dataset",
              "hetu_tpu_torch.data.packing", "hetu_tpu_torch.data.loader",
              "hetu_tpu_torch.data.prefetch", "hetu_tpu_torch.engine.trainer",
              "hetu_tpu_torch.engine.sft_trainer",
              "hetu_tpu_torch.nn.moe", "hetu_tpu_torch.engine.memory",
              "hetu_tpu_torch.serving.kv_pool",
              "hetu_tpu_torch.serving.speculative", "hetu_tpu_torch.peft",
              "hetu_tpu_torch.peft.lora", "hetu_tpu_torch.serving.tenancy",
              "hetu_tpu_torch.utils", "hetu_tpu_torch.utils.checkpoint",
              "hetu_tpu_torch.telemetry", "hetu_tpu_torch.telemetry.metrics",
              "hetu_tpu_torch.telemetry.tracecontext",
              "hetu_tpu_torch.serving.streaming",
              "hetu_tpu_torch.serving.server", "hetu_tpu_torch.rpc",
              "hetu_tpu_torch.rpc.stream", "hetu_tpu_torch.rpc.py_server",
              "hetu_tpu_torch.rpc.client", "hetu_tpu_torch.data.bucket",
              "hetu_tpu_torch.optim.scaler", "hetu_tpu_torch.optim.schedules",
              "hetu_tpu_torch.engine.step_graph"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'hetu_tpu' or m.startswith('hetu_tpu.')\n"
            "             or m == 'safetensors'\n"
            "             or m.startswith('safetensors.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "port_probe.py"]))
def test_no_jax_or_hetu_tpu_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "hetu_tpu", "safetensors")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_refuse_a_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from hetu_tpu_torch import resolve_device
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, generate
    from hetu_tpu_torch.serving import ServingEngine
    cfg = GPTConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTLMHeadModel(cfg)
    model = GPTLMHeadModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(model, [[1, 2, 3]], max_new_tokens=2)
    # asked for explicitly, the host path runs
    eng = ServingEngine(model, slots=2, max_len=32, device="cpu")
    assert eng.device.type == "cpu"
