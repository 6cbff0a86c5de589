"""Smoke of the sync subsystem: the file-channel publish/subscribe loop end to
end (port of ``repro/sync/smoke.py``).

  PYTHONPATH=src python -m repro_torch.sync.smoke --device cpu

Runs the protocol against a temporary directory and exits non-zero on any
failed check:

1. snapshot bootstrap over the file channel;
2. a values-only and a topology delta applied in order, bitwise equal to
   the publisher's plan;
3. one injected gap (a delta file deleted before the subscriber sees it)
   detected, resynced through the request-file back-channel, converged;
4. a live ServingEngine (the smoke model) drains the deltas at a chunk
   boundary with no decode step recaptured, every leaf tensor kept in
   place.

``--device cuda`` (the default) runs the engine on the card, where its
decode steps are captured CUDA graphs.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import model as M
from repro_torch.sparse import registry as REG
from repro_torch.sync import DirChannel, Publisher, Subscriber, engine_from_snapshot


def _check(ok: bool, what: str) -> None:
    print(f"[sync-smoke] {'ok' if ok else 'FAIL'}: {what}")
    if not ok:
        sys.exit(1)


def _bitwise_converged(sub, pub, reg) -> bool:
    for s in reg:
        leaf = REG.get_path(pub._plan.serving_tree, s.path)
        rec = sub.leaves[s.name]
        for f in leaf._array_fields:
            theirs, mine = getattr(leaf, f), rec.arrays.get(f)
            if (mine is None) != (theirs is None):
                return False
            if mine is not None and not torch.equal(mine, theirs.cpu()):
                return False
    return True


def _train_step(reg, params, masks, versions, *, rewire: bool):
    """Every float param times 1.003; with ``rewire`` the first stack's
    mask rolled by one input row (fan-in unchanged) and its version bumped."""
    params = _map(params, lambda x: x * 1.003 if x.is_floating_point() else x)
    if rewire:
        s = reg[0]
        masks = _map(masks, lambda x: x)
        REG.set_path(masks, s.path, torch.roll(REG.get_path(masks, s.path), 1, dims=-2))
        versions = dict(versions)
        versions[s.name] += 1
    return params, masks, versions


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaf_ptrs(eng, key, reg) -> dict:
    tree = eng.plan_for(key).serving_tree
    return {s.name: {f: t.data_ptr() for f, t in REG.get_path(tree, s.path).arrays().items()}
            for s in reg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    reg = REG.build_registry(cfg)
    params = M.init_params(cfg, gen, REG.k_fan_map(cfg, reg))
    masks = REG.init_sparsity_state(cfg, gen, reg)["masks"]
    versions = {s.name: 0 for s in reg}

    with tempfile.TemporaryDirectory(prefix="repro-torch-sync-") as tmp:
        ch = DirChannel(tmp)
        pub = Publisher(cfg, reg, ch, path="condensed", batch_size=2, arch=args.arch)
        info = pub.publish(params=params, masks=masks, mask_versions=versions)
        print(f"[sync-smoke] gen {info['generation']} {info['kind']} ({info['bytes']} B)")

        sub = Subscriber(ch.subscribe("smoke"), name="smoke")
        _check(sub.wait_for_bootstrap(timeout=5.0), "snapshot bootstrap")
        eng = engine_from_snapshot(cfg, sub, registry=reg, device=device, gen_chunk=4)

        # -- a values-only and a topology delta, applied live ---------------
        prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen, device=device,
                                dtype=torch.int32)
        rid = eng.submit(prompts.cpu(), 16)
        eng.step(max_chunks=2)
        key = eng.plan_key(2)
        ptrs = _leaf_ptrs(eng, key, reg)

        params, masks, versions = _train_step(reg, params, masks, versions, rewire=False)
        info = pub.publish(params=params, masks=masks, mask_versions=versions)
        _check(info["topology"] == [] and info["values_bytes"] > 0,
               f"gen {info['generation']} values-only delta ({info['bytes']} B)")
        params, masks, versions = _train_step(reg, params, masks, versions, rewire=True)
        info = pub.publish(params=params, masks=masks, mask_versions=versions)
        _check(len(info["topology"]) == 1,
               f"gen {info['generation']} topology delta ({info['bytes']} B, "
               f"{info['topology']})")

        captures, programs = eng.captures, eng.program_count("decode")
        eng.step()
        eng.retire(rid)
        _check(eng._sync_generation == pub.generation,
               f"engine drained to gen {eng._sync_generation}")
        _check(eng.captures == captures and eng.program_count("decode") == programs,
               "no decode step recaptured across the mid-stream update")
        _check(_leaf_ptrs(eng, key, reg) == ptrs, "every leaf tensor written in place")
        _check(_bitwise_converged(sub, pub, reg), "subscriber bitwise equal to the publisher")

        # -- injected gap -> resync ------------------------------------------
        params, masks, versions = _train_step(reg, params, masks, versions, rewire=True)
        info = pub.publish(params=params, masks=masks, mask_versions=versions)
        os.remove(os.path.join(tmp, f"{info['generation']:010d}-delta.rsd"))
        params, masks, versions = _train_step(reg, params, masks, versions, rewire=False)
        pub.publish(params=params, masks=masks, mask_versions=versions)
        sub.poll()
        _check(sub.counters["gaps"] >= 1 and sub.counters["resyncs"] >= 1,
               f"injected gap detected (gaps={sub.counters['gaps']}, resync requested)")
        served = pub.serve_resyncs()
        _check(served >= 1, f"publisher answered {served} resync request(s)")
        sub.poll()
        _check(sub.generation == pub.generation, f"resynced to gen {sub.generation}")
        _check(_bitwise_converged(sub, pub, reg), "bitwise equal after the resync")
        print(f"[sync-smoke] counters: { {k: v for k, v in sub.counters.items() if v} }")
    print("[sync-smoke] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
