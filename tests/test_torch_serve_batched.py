"""``examples/serve_batched_torch.py --device cpu`` runs end to end on
gemma3-1b's smoke config: its 48-token prompts wrap the 16-slot ring
caches of the local layers in prefill and again in decode; the cache it
reports is what ``init_cache`` allocates (rings for the local layers, full
caches for the global ones); and the streams it prints are the greedy
tokens of a step-by-step prefill and decode of the same seeded model."""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "examples", "serve_batched_torch.py")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, SCRIPT, "--device", "cpu", *args],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _streams(out: str) -> list[list[int]]:
    return [[int(t) for t in toks.split(",")]
            for toks in re.findall(r"stream \d: \.\.\.\[([\d, ]+)\]", out)]


def _step_by_step(batch=4, prompt_len=48, gen_len=24) -> torch.Tensor:
    """The example's model and prompts from the same seed, decoded one
    ``decode_step`` at a time."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sparse import registry as REG
    cfg = configs.get_smoke_config("gemma3-1b")
    gen = torch.Generator().manual_seed(0)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                            dtype=torch.int32)
    cache = M.init_cache(cfg, batch, prompt_len + gen_len, "cpu")
    with torch.no_grad():
        logits, cache = M.prefill_step(cfg, params, masks, {"tokens": prompts}, cache)
        toks = []
        for _ in range(gen_len):
            cur = torch.argmax(logits, -1).to(torch.int32)[:, None]
            toks.append(cur)
            logits, cache = M.decode_step(cfg, params, masks, {"tokens": cur}, cache)
    return torch.cat(toks, 1)


def test_serve_batched_torch_runs_on_the_cpu():
    out = _run()
    # gemma3 smoke: 2 groups of 2 local layers (16-slot rings) and 2 global
    # layers (72 positions), 4 streams, 1 kv head of 16, float32 k and v
    rings = 4 * 4 * 16 * 1 * 16 * 4 * 2
    full = 2 * 4 * 72 * 1 * 16 * 4 * 2
    cache = re.search(r"\[serve\] cache bytes: ([\d.]+) MB \(ring buffers cap local-attention "
                      r"layers at window=16; 72 positions a stream\)", out)
    assert cache is not None, out
    assert abs(float(cache.group(1)) - (rings + full) / 1e6) < 0.01
    assert "[serve] 4 streams x 24 tokens in" in out
    streams = _streams(out)
    assert streams == _step_by_step()[:2].tolist()
    assert _streams(_run()) == streams   # seeded: the same streams again
    assert "window=n/a" in _run("--arch", "qwen2-vl-7b", "--prompt-len", "8", "--gen", "4")
