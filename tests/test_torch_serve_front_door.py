"""The port's asyncio front door (``repro_torch.launch.serve.QueryServer``)
against the reference's (``repro.launch.serve``), on the CPU.

Both servers deploy the same chase Q1 statement over the same seeded
catalog and the reference's own IVF index (carried with
``ivf_from_numpy``).  Held: every submit resolves to a typed outcome
(result, BackpressureError, PoisonedBindError, DeadlineExceededError, the
contained kernel error) and never hangs; the outcome counts and admission
counters equal the reference's where the scenario fixes them; served rows
equal the statement's direct answers; drains that run on different worker
threads serve the same answers; ``submit_mutation`` with no live corpus
raises the reference's MutationError; the ``--front-door`` CLI runs with
``--device cpu``, and so does ``--arch`` (the LM path with its RAG
retrieval), with the reference's doc-token map and embeddings-mode exit.  Mirrors the
QueryServer cases of ``tests/test_resilience.py``.
"""
import asyncio
import concurrent.futures
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import connect as ref_connect
from repro.core import Metric as RefMetric
from repro.data import make_laion_catalog as ref_make_catalog
from repro.index import build_ivf as ref_build_ivf
from repro.index.ivf import ProbeConfig as RefProbe
from repro.launch import serve as ref_serve
from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_sched
from repro_torch.api import connect
from repro_torch.core.schema import Metric
from repro_torch.data import make_laion_catalog
from repro_torch.index import ivf_from_numpy
from repro_torch.index.ivf import ProbeConfig
from repro_torch.launch import serve as port_serve
from repro_torch.serving import faults as port_faults
from repro_torch.serving import resilience as port_res
from repro_torch.serving import scheduler as port_sched

SQL = ("SELECT sample_id FROM products WHERE price < ${p} "
       "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
SMALL = dict(n_rows=600, n_queries=8, dim=16, n_modes=8, seed=0)
FIELDS = ("centroids", "lists", "list_sizes", "radii", "centroid_sq")
PROBE = dict(max_probes=8, probe_batch=2, termination="counter")
PACKAGES = {"port": (port_serve, port_sched, port_res),
            "ref": (ref_serve, ref_sched, ref_res)}


@pytest.fixture(scope="module")
def env():
    ref_cat = ref_make_catalog(**SMALL)
    cat = make_laion_catalog(**SMALL, device="cpu")
    ref_idx = ref_build_ivf(jax.random.key(0), ref_cat.table("laion")["vec"],
                            nlist=8, metric=RefMetric.INNER_PRODUCT, iters=2)
    fields = {f: np.asarray(getattr(ref_idx, f)) for f in FIELDS}
    fields.update(nlist=ref_idx.nlist, cap=ref_idx.cap)
    ref_cat.register_index("products", "embedding", ref_idx)
    cat.register_index("products", "embedding",
                       ivf_from_numpy(fields, Metric.INNER_PRODUCT, "cpu"))
    stmts = {"port": connect(cat, engine="chase",
                             probe=ProbeConfig(**PROBE)).prepare(SQL),
             "ref": ref_connect(ref_cat, engine="chase",
                                probe=RefProbe(**PROBE)).prepare(SQL)}
    qs = cat.table("queries")["embedding"].numpy().astype(np.float32)
    return stmts, qs


def _binds(qs, i=0):
    return {"qv": qs[i % qs.shape[0]], "p": np.float32(1e9)}


def _serve_config(pkg, watermark, max_batch=4, max_wait_ms=100.0,
                  deadline_ms=None):
    serve, sched, res = PACKAGES[pkg]
    return serve.ServeConfig(
        admission=res.AdmissionConfig(max_queue_depth=watermark,
                                      retry_after_ms=5.0),
        scheduler=sched.SchedulerConfig(max_batch=max_batch,
                                        max_wait_ms=max_wait_ms,
                                        default_deadline_ms=deadline_ms),
        policy=res.DegradePolicy(steps=((8, 4),), hysteresis=2),
        idle_tick_ms=5.0)


def _ids(res):
    v = res.ids
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_backpressure_is_typed_and_counted(env, pkg):
    stmts, qs = env
    serve, _sched, res = PACKAGES[pkg]

    async def scenario():
        server = serve.QueryServer(stmts[pkg], _serve_config(pkg, 4))
        server.scheduler.warm(_binds(qs, 0), [1, 2, 4])
        async with server:
            outs = await asyncio.gather(
                *(server.submit(_binds(qs, i)) for i in range(12)),
                return_exceptions=True)
            snap = server.snapshot()
        return outs, snap

    outs, snap = asyncio.run(scenario())
    ok = [o for o in outs if not isinstance(o, BaseException)]
    bp = [o for o in outs if isinstance(o, res.BackpressureError)]
    assert len(ok) == 4 and len(bp) == 8
    assert all(e.retry_after_ms > 0 for e in bp)
    assert all(_ids(r).shape == (4,) for r in ok)
    assert snap["admission"] == {"admitted": 4, "rejected": 8}
    assert snap["executed"] == 4 and snap["in_flight"] == 0


def test_served_rows_equal_direct_answers(env):
    """The port's admitted requests equal the statement's single-dict
    answers (and the reference server's ids)."""
    stmts, qs = env

    def run(pkg):
        serve = PACKAGES[pkg][0]

        async def scenario():
            server = serve.QueryServer(stmts[pkg], _serve_config(pkg, 64))
            async with server:
                return await asyncio.gather(
                    *(server.submit(_binds(qs, i)) for i in range(6)))

        return asyncio.run(scenario())

    port, ref = run("port"), run("ref")
    for i, (a, b) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(_ids(a), _ids(b))
        direct = stmts["port"].execute([_binds(qs, i)])
        assert torch.equal(a["ids"], direct["ids"][0])
        assert torch.equal(a["stats"]["probes"], direct["stats"]["probes"][0])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_rejects_poison_and_sheds_deadlines(env, pkg):
    stmts, qs = env
    serve, _sched, res = PACKAGES[pkg]

    async def scenario():
        server = serve.QueryServer(stmts[pkg], _serve_config(pkg, 64))
        server.scheduler.warm(_binds(qs, 0), [1])
        bad = dict(_binds(qs, 0))
        bad["qv"] = np.full_like(bad["qv"], np.nan)
        async with server:
            with pytest.raises(res.PoisonedBindError):
                await server.submit(bad)
            with pytest.raises(res.DeadlineExceededError):
                await server.submit(_binds(qs, 1), deadline_ms=1e-3)
            ok = await server.submit(_binds(qs, 2))
        return ok, server.snapshot()

    ok, snap = asyncio.run(scenario())
    assert _ids(ok).shape == (4,)
    assert snap["shed_deadline"] == 1
    assert snap["admission"]["admitted"] == 3
    assert snap["in_flight"] == 0


def test_rejects_a_poisoned_tensor_bind(env):
    stmts, qs = env

    async def scenario():
        server = port_serve.QueryServer(stmts["port"],
                                        _serve_config("port", 64))
        async with server:
            bad = {"qv": torch.full((16,), float("nan")),
                   "p": np.float32(1e9)}
            with pytest.raises(port_res.PoisonedBindError, match="qv"):
                await server.submit(bad)
            ok = await server.submit({"qv": torch.from_numpy(qs[3]),
                                      "p": np.float32(1e9)})
        return ok

    ok = asyncio.run(scenario())
    want = stmts["port"].execute([_binds(qs, 3)])
    assert torch.equal(ok["ids"], want["ids"][0])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_lifecycle_guards(env, pkg):
    stmts, qs = env
    serve = PACKAGES[pkg][0]

    async def scenario():
        server = serve.QueryServer(stmts[pkg], _serve_config(pkg, 4))
        with pytest.raises(RuntimeError, match="not running"):
            await server.submit(_binds(qs, 0))
        with pytest.raises(RuntimeError, match="not running"):
            await server.submit_mutation("compact")
        async with server:
            with pytest.raises(RuntimeError, match="already started"):
                await server.start()
        await server.stop()                 # second stop is a no-op

    asyncio.run(scenario())


@pytest.mark.parametrize("op", ["insert", "delete", "compact", "merge"])
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_submit_mutation_without_a_live_corpus(env, pkg, op):
    stmts, _qs = env
    serve, _sched, res = PACKAGES[pkg]

    async def scenario():
        async with serve.QueryServer(stmts[pkg],
                                     _serve_config(pkg, 4)) as server:
            with pytest.raises(res.MutationError, match="no live corpus"):
                await server.submit_mutation(op, ids=[1],
                                             vectors=np.ones((1, 16)))
            return server.snapshot()

    snap = asyncio.run(scenario())
    assert snap["admission"] == {"admitted": 1, "rejected": 0}


@pytest.mark.parametrize("seed", [0, 5])
def test_every_future_resolves_under_faults(env, seed):
    """Kernel errors, latency spikes, poisoned binds and catalog bumps on a
    staggered-then-burst run: each submit ends in a result or a typed
    error, and the failed count is the members of the failed batches."""
    stmts, qs = env
    stmt = stmts["port"]
    cat = stmt._db.catalog
    index = cat.index_for("products", "embedding")
    inj = port_faults.FaultInjector(
        port_faults.FaultSpec(seed=seed, latency_spike_p=0.2,
                              latency_spike_ms=2.0, kernel_error_p=0.3,
                              poison_bind_p=0.1, catalog_bump_p=0.3),
        bump_fn=lambda: cat.register_index("products", "embedding", index))
    n = 48

    async def scenario():
        server = port_serve.QueryServer(
            stmt, _serve_config("port", 32, max_batch=8, max_wait_ms=1.0,
                                deadline_ms=200.0), faults=inj)

        async def one(i):
            await asyncio.sleep(i * 0.0005 if i < n // 2 else 0)
            return await server.submit(_binds(qs, i))

        async with server:
            outs = await asyncio.wait_for(asyncio.gather(
                *(one(i) for i in range(n)), return_exceptions=True),
                timeout=120)
            snap = server.snapshot()
        return outs, snap

    outs, snap = asyncio.run(scenario())
    kinds = {}
    for o in outs:
        kinds[type(o).__name__] = kinds.get(type(o).__name__, 0) + 1
    assert set(kinds) <= {"Result", "InjectedKernelError", "PoisonedBindError",
                          "BackpressureError", "DeadlineExceededError"}
    assert kinds.get("InjectedKernelError", 0) == snap["failed"]
    assert kinds.get("PoisonedBindError", 0) == \
        snap["faults"]["poisoned_binds"]
    assert snap["in_flight"] == 0
    assert snap["executed"] == kinds.get("Result", 0)
    for o in outs:
        if type(o).__name__ == "Result":
            assert o["ids"].shape == (4,)


def test_drains_on_worker_threads(env):
    """The drain loop runs each poll on the loop's default executor; when
    its calls alternate between two threads, the drains still serve the
    statement's own answers."""
    stmts, qs = env
    stmt = stmts["port"]
    threads = set()

    class Tracing(port_sched.ResilientScheduler):
        def execute(self, binds_list):
            threads.add(threading.get_ident())
            return super().execute(binds_list)

    class Alternating(concurrent.futures.ThreadPoolExecutor):
        """Hands each call to the next of two one-thread pools."""

        def __init__(self):
            super().__init__(1)
            self.pools = [concurrent.futures.ThreadPoolExecutor(1)
                          for _ in range(2)]
            self.turn = 0

        def submit(self, fn, /, *args, **kwargs):
            self.turn += 1
            return self.pools[self.turn % 2].submit(fn, *args, **kwargs)

        def shutdown(self, wait=True, **kw):
            for pool in self.pools:
                pool.shutdown(wait)
            super().shutdown(wait, **kw)

    async def scenario():
        asyncio.get_running_loop().set_default_executor(Alternating())
        server = port_serve.QueryServer(stmt, _serve_config(
            "port", 64, max_batch=2, max_wait_ms=0.0))
        server.scheduler = Tracing(stmt, server.config.scheduler,
                                   policy=server.config.policy)
        async with server:
            outs = []
            for i in range(12):
                outs.append(await server.submit(_binds(qs, i)))
        return outs

    outs = asyncio.run(scenario())
    assert len(threads) == 2
    for i, o in enumerate(outs):
        want = stmt.execute([_binds(qs, i)])
        assert torch.equal(o["ids"], want["ids"][0])


def test_serve_config_defaults_match_reference():
    assert dataclasses.asdict(port_serve.ServeConfig()) == \
        dataclasses.asdict(ref_serve.ServeConfig())


def test_front_door_cli_on_cpu(capsys):
    assert port_serve.main(["--front-door", "--device", "cpu",
                            "--requests", "32", "--rows", "800"]) == 0
    out = capsys.readouterr().out
    assert "[front-door] 32 requests" in out and "on cpu" in out
    line = next(ln for ln in out.splitlines() if "outcomes" in ln)
    counts = eval(line.split("outcomes: ", 1)[1])   # a printed dict literal
    assert sum(counts.values()) == 32


def test_arch_cli_runs_on_cpu(capsys):
    assert port_serve.main(["--arch", "qwen2-1.5b", "--smoke", "--rag",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] retrieved docs per request" in out
    assert "[serve] generated 32 tokens" in out and "on cpu" in out
    with pytest.raises(SystemExit):
        port_serve.main([])


def test_arch_doc_tokens_match_the_reference_expression():
    """``ids * 7919 % vocab`` in int32: the product wraps past 271,183
    docs and the remainder stays non-negative, also for the -1 lanes."""
    ids = np.array([[-1, 0, 1, 271_183], [271_184, 999_999, 1_000_000,
                                          2**31 - 1]], np.int32)
    for vocab in (151_936, 512, 32_000):
        want = (ids * 7919 % vocab).astype(np.int32)
        got = port_serve.doc_tokens(torch.from_numpy(ids), vocab)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got >= 0).all()


def test_arch_cli_refuses_embeddings_mode_as_the_reference():
    with pytest.raises(SystemExit) as want:
        ref_serve.main(["--arch", "musicgen-medium", "--smoke"])
    with pytest.raises(SystemExit) as got:
        port_serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                         "cpu"])
    assert str(got.value) == str(want.value)
    assert "embeddings-mode" in str(got.value)
