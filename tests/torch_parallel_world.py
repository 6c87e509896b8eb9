"""A world of gloo ranks on the CPU for the port's parallel tests
(``tests/test_torch_parallel*.py``), in the role the 8-device virtual mesh
of ``tests/conftest.py`` plays for the JAX tests.

``run_world(cases, world, tmp)`` starts ``world`` processes once (python
-m tests.torch_parallel_world PLAN RANK); they join one gloo world through
a file store under ``tmp`` (no port, so parallel test workers never
collide), each pinned to one intra-op thread, and run every case of the
plan in order. Each case builds its mesh on every rank (group creation is
collective); the ranks in it run the case, and the first of them writes
the result (``per_rank``: each of them writes its own). The test process
then compares the results with the JAX engines. This module imports
torch and the port only: the ranks never import JAX.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def run_world(cases: list[dict], world: int, tmp, timeout_s: float = 600.0,
              coordinator: str | None = None) -> dict:
    """Run ``cases`` in one world of ``world`` ranks; returns {case name:
    result} (per-rank cases: {name: {rank: result}}). A case that raised
    on its ranks gives {"error": repr, "traceback": ...}. ``coordinator``
    (host:port) joins the ranks over TCP instead, as separate hosts do."""
    tmp = Path(tmp)
    plan = tmp / "plan.json"
    out = tmp / "out"
    out.mkdir(parents=True, exist_ok=True)
    plan.write_text(json.dumps({"cases": cases, "out": str(out), "world": world,
                                "store": coordinator or f"file://{tmp / 'store'}"}))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_world", str(plan),
                               str(r)], cwd=str(REPO), env=env, stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r].read_text()[-4000:]}"
    results = {}
    for c in cases:
        if c.get("per_rank"):
            results[c["name"]] = {int(f.name.split(".r")[-1][:-4]): pickle.loads(f.read_bytes())
                                  for f in out.glob(f"{c['name']}.r*.pkl")}
        else:
            results[c["name"]] = pickle.loads((out / f"{c['name']}.pkl").read_bytes())
    return results


# ---------------------------------------------------------------- the ranks

def _mesh(case):
    from xalm_tpu_torch.parallel.mesh import make_mesh
    from xalm_tpu_torch.parallel.pipeline import make_pp_mesh

    m = case["mesh"]
    if "pp" in m:
        return make_pp_mesh(m["pp"], tp=m.get("tp", 1), device="cpu")
    return make_mesh(dp=m.get("dp", 1), tp=m["tp"], device="cpu")


def _kv(name):
    import torch

    return {None: "auto", "f32": torch.float32, "i8": torch.int8, "f16": torch.float16}[name]


def _engine(case, mesh):
    from xalm_tpu_torch.parallel.pipeline import PipelinedEngine
    from xalm_tpu_torch.parallel.sharded_engine import ShardedEngine

    kw = dict(case.get("engine", {}))
    if "kv" in kw:
        kw["kv_dtype"] = _kv(kw.pop("kv"))
    if "pp" in case["mesh"]:
        return PipelinedEngine.from_xalm(case["model"], mesh, **kw)
    return ShardedEngine.from_xalm(case["model"], mesh, **kw)


def _np(t):
    import torch

    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _run(case, mesh):  # noqa: C901 (one branch a kind of case)
    from xalm_tpu_torch import prng
    from xalm_tpu_torch.parallel import aot

    kind, a = case["kind"], case.get("args", {})
    if kind == "construct":  # a refusal: the error's type and text
        try:
            _engine(case, mesh)
        except Exception as e:  # noqa: BLE001 (the test reads the type)
            return {"raised": type(e).__name__, "message": str(e)}
        return {"raised": None}
    eng = _engine(case, mesh)
    if kind == "step":  # tokens (b, T) at pos 0 -> logits
        cache = eng.new_cache(len(a["tokens"]))
        logits, _ = eng.step(np.asarray(a["tokens"]), np.zeros(len(a["tokens"]), np.int32),
                             cache, logits_mode=a.get("mode", "all"))
        return {"logits": _np(logits), "decode_path": eng.decode_path(1)}
    if kind == "step_then_scan":  # prompts (b, T), then decode_scan n
        toks = np.asarray(a["tokens"], np.int32)
        b, t = toks.shape
        cache = eng.new_cache(b)
        logits, cache = eng.step(toks, np.zeros(b, np.int32), cache, logits_mode="last")
        tok0 = _np(logits).argmax(-1).astype(np.int32)
        out, _ = eng.decode_scan(tok0, np.full(b, t, np.int32), cache, a["n"])
        return {"tok0": tok0, "tokens": _np(out).astype(np.int64)}
    if kind == "decode_steps":  # token-by-token decode -> the last logits
        cache = eng.new_cache(1)
        for i, t in enumerate(a["tokens"]):
            logits, cache = eng.decode(np.array([t]), np.array([i], np.int32), cache)
        return {"logits": _np(logits)}
    if kind == "generate":
        out = [eng.generate(a["prompt"], a["n"], stop_on_eos=False, **a.get("kw", {}))[0]
               for _ in range(a.get("times", 1))]
        return {"tokens": out}
    if kind == "prefill":
        logits, _, pos = eng.prefill(a["tokens"], eng.new_cache(1), logits_mode=a["mode"])
        return {"logits": _np(logits), "pos": pos}
    if kind == "perplexity":
        return {"ppl": eng.perplexity(a["tokens"])}
    if kind == "sample_scan":  # twice from the same key
        toks = np.asarray(a["tokens"], np.int32)
        runs = []
        for _ in range(2):
            cache = eng.new_cache(len(toks))
            _, cache = eng.step(toks[:, None], np.zeros(len(toks), np.int32), cache,
                                logits_mode="none")
            out, _ = eng._sample_scan(toks, np.ones(len(toks), np.int32), cache,
                                      prng.PRNGKey(a["seed"]), a["n"], temperature=a["temp"])
            runs.append(_np(out).astype(np.int64))
        return {"runs": runs}
    if kind == "shapes":  # this rank's shard and cache block shapes
        cache = eng.new_cache(a.get("batch", 1))
        lp = eng.params.layers
        return {"wqkv": tuple(lp.wqkv.values.shape), "cache": tuple(cache.k.shape),
                "wcls": tuple(eng.params.wcls.values.shape), "coords": mesh.coords()}
    if kind == "collectives":  # per-step counts of a decode step and of a scan step
        cache = eng.new_cache(a["batch"])
        toks = np.zeros((a["batch"], 1), np.int32)
        pos = np.zeros(a["batch"], np.int32)
        step = aot.collective_stats(eng.step, toks, pos, cache, logits_mode="token")
        scan = aot.collective_stats(eng.decode_scan, toks[:, 0], pos + 1, cache, a["n"])
        return {"step": step, "scan": scan, "n_layers": eng.cfg.n_layers}
    if kind == "copy_lane":  # lane src's rows copied onto lane dst, then one step of all
        b, toks = a["batch"], np.asarray(a["tokens"], np.int32)
        cache = eng.new_cache(b)
        valid = np.zeros((b, len(toks)), bool)
        valid[a["src"]] = True
        eng.step(np.tile(toks, (b, 1)), np.zeros(b, np.int32), cache, valid, logits_mode="none")
        eng.copy_lane(cache, a["dst"], a["src"])
        logits, _ = eng.step(np.full((b, 1), a["next"], np.int32),
                             np.full(b, len(toks), np.int32), cache, logits_mode="last")
        return {"logits": _np(logits)}
    if kind == "spec":
        from xalm_tpu_torch.runtime.spec import generate_spec

        return {"tokens": generate_spec(eng, [1, 259, 260], 4, k=2)[0]}
    if kind == "multihost":  # dp spanning processes: per-host feeding, then the engine
        from xalm_tpu_torch.parallel.multihost import all_hosts, host_local_to_global

        prompts = np.asarray(a["prompts"], np.int32)
        d = mesh.axis("dp").index
        fed = host_local_to_global(mesh, ("dp", None), prompts[d:d + 1])
        cache = eng.new_cache(len(prompts))
        logits, cache = eng.step(prompts, np.zeros(len(prompts), np.int32), cache,
                                 logits_mode="last")
        tok0 = all_hosts(logits).argmax(-1).astype(np.int32)
        toks, _ = eng.decode_scan(tok0, np.full(len(prompts), prompts.shape[1], np.int32),
                                  cache, a["n"])
        return {"fed_shape": fed.shape, "fed": all_hosts(fed), "tok0": tok0,
                "generated": all_hosts(toks)}
    raise ValueError(f"unknown case kind {kind!r}")


def main(plan_path: str, rank: int) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from xalm_tpu_torch.parallel.multihost import init_distributed

    plan = json.loads(Path(plan_path).read_text())
    init_distributed(plan["store"], plan["world"], rank, device="cpu", timeout_s=300)
    out = Path(plan["out"])
    for case in plan["cases"]:
        mesh = _mesh(case)
        if mesh.member:
            try:
                with torch.inference_mode(case.get("inference", False)):
                    result = _run(case, mesh)
            except Exception as e:  # noqa: BLE001 (reported to the test)
                result = {"error": repr(e), "traceback": traceback.format_exc()}
            if case.get("per_rank"):
                (out / f"{case['name']}.r{rank}.pkl").write_bytes(pickle.dumps(result))
            elif rank == mesh.ranks[0]:
                (out / f"{case['name']}.pkl").write_bytes(pickle.dumps(result))
        dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
