"""Serving launcher of the port: the resilient asyncio front door for
hybrid queries (the port of ``src/repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --front-door \
      --requests 64 [--device cpu]

:class:`QueryServer` stacks the full resilience pipeline over one prepared
statement: **admission control** (bounded in-flight watermark ->
:class:`~repro_torch.serving.resilience.BackpressureError` with a
retry-after hint), **bind validation** (poisoned payloads rejected at the
door), **deadlines** (expired requests shed before execution), and
**graceful degradation** (probe budgets step down under queue pressure;
served results report degraded mode in ``explain()``).
``await server.submit(binds)`` resolves to the request's
:class:`~repro_torch.api.result.Result` or raises its typed serving error —
never a hang.  A drain runs on the event loop's default executor (a worker
thread), on the served plan's device and stream, and the request's future
resolves once the card has finished its batch.

LM decode path, with an optional CHASE hybrid retrieval before decoding
(``serve_arch`` runs it and returns the retrieval, the tokens and the
timings; ``main`` prints what the reference prints):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --smoke --batch 2 --prompt-len 16 --gen 16 --rag [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Any

import numpy as np

from ..serving.resilience import (AdmissionConfig, AdmissionController,
                                  BackpressureError, DeadlineExceededError,
                                  DegradePolicy, MutationError,
                                  validate_binds)
from ..serving.scheduler import ResilientScheduler, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Front-door knobs: admission + scheduler + degradation policy.

    ``idle_tick_ms`` bounds how long the drain loop sleeps with work queued
    (the liveness backstop: even if no submit ever kicks the loop again, a
    queued request is examined within one tick)."""
    admission: AdmissionConfig = AdmissionConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    policy: DegradePolicy | None = DegradePolicy()
    idle_tick_ms: float = 50.0


class QueryServer:
    """Asyncio front door over a
    :class:`~repro_torch.serving.scheduler.ResilientScheduler`.

    One server serves one prepared statement (the deployment unit).  Use as
    an async context manager::

        async with QueryServer(stmt, config) as server:
            res = await server.submit({"qv": q, "p": 0.5}, deadline_ms=20)

    ``submit`` applies the admission pipeline inline (backpressure, bind
    validation) and then awaits the request's outcome; the background drain
    loop coalesces queued requests and runs batches on the default executor
    thread so the event loop never blocks on a kernel."""

    def __init__(self, statement, config: ServeConfig | None = None,
                 faults=None):
        self.config = config if config is not None else ServeConfig()
        self.scheduler = ResilientScheduler(statement,
                                            self.config.scheduler,
                                            policy=self.config.policy,
                                            faults=faults)
        self.admission = AdmissionController(self.config.admission)
        self.faults = faults
        self._futures: dict[int, asyncio.Future] = {}
        self._kick: asyncio.Event | None = None
        self._loop_task: asyncio.Task | None = None
        self._running = False

    @property
    def statement(self):
        """The prepared Statement this server deploys."""
        return self.scheduler.statement

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "QueryServer":
        """Start the background drain loop (idempotence-guarded)."""
        if self._running:
            raise RuntimeError("server already started")
        self._kick = asyncio.Event()
        self._running = True
        self._loop_task = asyncio.create_task(self._drain_loop())
        return self

    async def stop(self) -> None:
        """Graceful shutdown: stop admitting, drain everything queued,
        resolve every in-flight future (no request is left dangling)."""
        if not self._running:
            return
        self._running = False
        self._kick.set()
        await self._loop_task
        loop = asyncio.get_running_loop()
        done = await loop.run_in_executor(None, self._finished,
                                          self.scheduler.flush)
        for rid in done:
            self._resolve(rid)
        for rid, fut in list(self._futures.items()):
            if not fut.done():
                fut.set_exception(RuntimeError(
                    f"server stopped with request {rid} unresolved"))
            self._futures.pop(rid, None)

    async def __aenter__(self) -> "QueryServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- request path -------------------------------------------------------

    async def submit(self, binds: dict, *, deadline_ms: float | None = None,
                     priority: int | None = None) -> Any:
        """Admit, enqueue, and await one request.

        Raises :class:`~repro_torch.serving.resilience.BackpressureError`
        at the door when in-flight depth is at the watermark,
        :class:`~repro_torch.serving.resilience.PoisonedBindError` on
        non-finite payloads, :class:`~repro_torch.serving.resilience.
        DeadlineExceededError` if the request expires while queued, and
        whatever the execution itself raised (contained per batch).
        Otherwise resolves to the request's
        :class:`~repro_torch.api.result.Result` view."""
        if not self._running:
            raise RuntimeError("server is not running (use `async with` "
                               "or call start())")
        self.admission.admit(len(self._futures))
        if self.faults is not None:
            binds, _poisoned = self.faults.maybe_poison(binds)
        validate_binds(binds)
        hints = getattr(self.statement, "hints", None)
        if deadline_ms is None and hints is not None:
            deadline_ms = hints.deadline_ms
        if priority is None:
            priority = getattr(hints, "priority", 0) if hints else 0
        rid = self.scheduler.submit_request(binds, deadline_ms=deadline_ms,
                                            priority=priority)
        fut = asyncio.get_running_loop().create_future()
        self._futures[rid] = fut
        self._kick.set()
        return await fut

    async def submit_mutation(self, op: str, ids=None, vectors=None,
                              columns=None) -> int:
        """Admit and apply one corpus mutation against the served
        statement's live corpus; returns the mutation's LSN.

        ``op`` is ``"insert"`` (requires ``ids`` + ``vectors``),
        ``"delete"`` (requires ``ids``), or ``"compact"``.  Mutations share
        the query admission watermark.  The mutation runs on the event
        loop's thread pool under the live corpus's lock; a drain re-binds
        the plan on its own thread under the same lock, so it sees each
        mutation whole or not at all.  A table without a live corpus
        raises :class:`~repro_torch.serving.resilience.MutationError`."""
        from ..core.compiler import _scan_of
        if not self._running:
            raise RuntimeError("server is not running (use `async with` "
                               "or call start())")
        self.admission.admit(len(self._futures))
        stmt = self.statement
        live = stmt._db.catalog.live_for(*_scan_of(stmt.compiled.analysis))
        if live is None:
            raise MutationError(
                "served statement's table has no live corpus attached; "
                "call db.attach_live(...) before submitting mutations")
        if op == "insert":
            call = lambda: live.insert(ids, vectors, columns)  # noqa: E731
        elif op == "delete":
            call = lambda: live.delete(ids)  # noqa: E731
        elif op == "compact":
            call = lambda: live.compact()  # noqa: E731
        else:
            raise MutationError(
                f"unknown mutation op {op!r}; expected "
                f"'insert', 'delete', or 'compact'")
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, call)

    def snapshot(self) -> dict:
        """Admission + scheduler + load (+ fault) counters in one view."""
        return {"admission": self.admission.snapshot(),
                "in_flight": len(self._futures),
                **self.scheduler.snapshot()}

    # -- internals ----------------------------------------------------------

    def _finished(self, drain) -> list[int]:
        """Run a drain (on an executor thread) and wait for the card to
        finish its batch, so a resolved request's tensors are complete."""
        done = drain()
        if done:
            self.scheduler.synchronize()
        return done

    def _resolve(self, rid: int) -> None:
        fut = self._futures.pop(rid, None)
        if fut is None or fut.done():
            return
        try:
            out = self.scheduler.result(rid)
        except Exception as e:
            fut.set_exception(e)
        else:
            fut.set_result(out)

    async def _drain_loop(self) -> None:
        loop = asyncio.get_running_loop()
        sched = self.scheduler
        while self._running:
            self._kick.clear()
            done = await loop.run_in_executor(None, self._finished,
                                              sched.poll)
            for rid in done:
                self._resolve(rid)
            if sched.pending():
                # work queued but not yet due: sleep to (at most) the
                # coalescing window so the due-check lands on time
                await asyncio.sleep(
                    min(self.config.scheduler.max_wait_ms,
                        self.config.idle_tick_ms) * 1e-3)
            else:
                try:
                    await asyncio.wait_for(
                        self._kick.wait(),
                        timeout=self.config.idle_tick_ms * 1e-3)
                except asyncio.TimeoutError:
                    pass


# -- demo traffic -----------------------------------------------------------


def _build_demo_statement(n_rows: int, seed: int, device: str = "cuda"):
    """A small VKNN-SF deployment: LAION-style catalog + IVF index, on
    ``device``."""
    import torch

    from ..api import connect
    from ..core import Metric
    from ..data import make_laion_catalog
    from ..index import build_ivf
    from ..index.ivf import ProbeConfig

    cat = make_laion_catalog(n_rows=n_rows, n_queries=8, dim=16, n_modes=8,
                             seed=seed, device=device)
    idx = build_ivf(torch.Generator().manual_seed(seed),
                    cat.table("laion")["vec"], nlist=32,
                    metric=Metric.INNER_PRODUCT, iters=3)
    cat.register_index("products", "embedding", idx)
    db = connect(cat, engine="chase",
                 probe=ProbeConfig(max_probes=32, probe_batch=2,
                                   termination="counter"))
    stmt = db.prepare("SELECT sample_id FROM products WHERE price < ${p} "
                      "ORDER BY DISTANCE(embedding, ${qv}) LIMIT 4")
    return cat, stmt


async def _front_door_demo(args) -> int:
    cat, stmt = _build_demo_statement(args.rows, args.seed, args.device)
    qs = cat.table("queries")["embedding"].cpu().numpy().astype(np.float32)
    config = ServeConfig(
        admission=AdmissionConfig(max_queue_depth=args.watermark),
        scheduler=SchedulerConfig(max_batch=16, max_wait_ms=1.0,
                                  default_deadline_ms=args.deadline_ms),
        policy=DegradePolicy(steps=((8, 8), (16, 4)), hysteresis=2))
    outcomes = {"ok": 0, "degraded": 0, "backpressure": 0, "deadline": 0}

    async def one(i: int) -> None:
        binds = {"qv": qs[i % qs.shape[0]], "p": np.float32(1e9)}
        try:
            # staggered arrivals: early requests see a shallow queue (full
            # effort), the later burst pushes into degraded territory
            await asyncio.sleep(i * 0.001 if i < args.requests // 2 else 0)
            res = await server.submit(binds)
        except BackpressureError:
            outcomes["backpressure"] += 1
        except DeadlineExceededError:
            outcomes["deadline"] += 1
        else:
            rep = res.explain()
            outcomes["degraded" if rep.degraded else "ok"] += 1

    t0 = time.perf_counter()
    async with QueryServer(stmt, config) as server:
        server.scheduler.warm({"qv": qs[0], "p": np.float32(1e9)}, [1, 16])
        await asyncio.gather(*(one(i) for i in range(args.requests)))
        snap = server.snapshot()
    dt = time.perf_counter() - t0
    print(f"[front-door] {args.requests} requests in {dt:.2f}s on "
          f"{args.device}")
    print(f"[front-door] outcomes: {outcomes}")
    print(f"[front-door] snapshot: {snap}")
    return 0


# -- the LM decode path ------------------------------------------------------


def doc_tokens(ids, vocab_size: int):
    """The stub doc -> token map ``ids * 7919 % vocab`` in int32 arithmetic:
    the product wraps at 2**31 as the reference's numpy int32 product does
    (past 271,183 docs), and the remainder is non-negative (invalid lanes
    are -1)."""
    import torch

    prod = ids.to(torch.int64) * 7919
    prod = (prod + 2**31) % 2**32 - 2**31
    return torch.remainder(prod, vocab_size).to(torch.int32)


@dataclasses.dataclass
class ArchServe:
    """What one ``serve_arch`` run made and measured.  ``retriever``,
    ``docs``, ``query_embeddings``, ``ids``, ``sims`` and ``valid`` are None
    without ``rag``; ``timings`` holds seconds (``init_s``, ``rag_build_s``,
    ``retrieve_s``, ``generate_s`` and its parts ``prefill_s`` and
    ``decode_s``), each read after the device finished."""
    cfg: Any
    params: dict
    prompts: Any
    prefix: Any
    tokens: Any
    timings: dict
    retriever: Any = None
    docs: Any = None
    query_embeddings: Any = None
    ids: Any = None
    sims: Any = None
    valid: Any = None


def _synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_arch(arch: str, *, smoke: bool = False, batch: int = 2,
               prompt_len: int = 16, gen: int = 16, rag: bool = False,
               rag_docs: int = 2000, seed: int = 0,
               device: str = "cuda") -> ArchServe:
    """Batched greedy generation for ``arch`` with random parameters from
    ``seed``, on ``device``; with ``rag``, a CHASE hybrid retrieval first
    (``HybridRetriever`` over ``rag_docs`` unit docs of width d_model,
    freshness >= 0.25 and safety = 0, K = 4), whose doc ids become token
    prefixes.  The parameters, prompts and docs are drawn on ``device``
    from ``torch.Generator`` s seeded with ``seed``."""
    import torch

    from ..configs import get_config
    from ..models import init_params
    from ..serving.decode import generate
    from ..serving.rag import HybridRetriever

    cfg = get_config(arch, smoke=smoke)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{arch} is embeddings-mode; use the "
                         "hybrid_serving example for frontend-stub serving")
    dev = torch.device(device)
    timings = {}
    t0 = time.perf_counter()
    g = torch.Generator(dev).manual_seed(seed)
    params = init_params(g, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=dev, dtype=torch.int32)
    _synchronize(dev)
    timings["init_s"] = time.perf_counter() - t0
    run = ArchServe(cfg, params, prompts, prompts, None, timings)

    if rag:
        t0 = time.perf_counter()
        gd = torch.Generator(dev).manual_seed(seed)
        docs = torch.randn((rag_docs, cfg.d_model), generator=gd,
                           device=dev)
        docs.div_(torch.linalg.vector_norm(docs, dim=1, keepdim=True))
        fresh = torch.rand(rag_docs, generator=gd, device=dev)
        safety = torch.randint(0, 4, (rag_docs,), generator=gd, device=dev,
                               dtype=torch.int32)
        run.retriever = HybridRetriever.build(docs, fresh, safety, k=4)
        run.docs = (docs, fresh, safety)
        _synchronize(dev)
        timings["rag_build_s"] = time.perf_counter() - t0
        # query embedding = mean prompt embedding (stub encoder)
        t0 = time.perf_counter()
        qemb = params["embed"][prompts.long()].to(torch.float32).mean(1)
        qemb = qemb / (torch.linalg.vector_norm(qemb, dim=-1, keepdim=True)
                       + 1e-6)
        run.query_embeddings = qemb
        run.ids, run.sims, run.valid = run.retriever.retrieve_batch(
            qemb, min_freshness=0.25, safety_class=0)
        _synchronize(dev)
        timings["retrieve_s"] = time.perf_counter() - t0
        # doc ids map to doc token prefixes (stub: hash to token ids)
        run.prefix = torch.cat([doc_tokens(run.ids, cfg.vocab_size)
                                .to(dev), prompts], dim=1)

    t0 = time.perf_counter()
    run.tokens = generate(params, cfg, run.prefix, gen, timings=timings)
    _synchronize(dev)
    timings["generate_s"] = time.perf_counter() - t0
    return run


def main(argv=None) -> int:
    """CLI: the --front-door resilience demo, or the LM decode path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="LM decode path: model architecture")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rag", action="store_true",
                    help="hybrid retrieval (CHASE VKNN-SF) before decode")
    ap.add_argument("--rag-docs", type=int, default=2000)
    ap.add_argument("--front-door", action="store_true",
                    help="resilient hybrid-query front-door demo")
    ap.add_argument("--device", default="cuda",
                    help="where the catalog, the parameters and the docs "
                    "live and the plans and the model run")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rows", type=int, default=1500)
    ap.add_argument("--watermark", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.front_door:
        return asyncio.run(_front_door_demo(args))
    if not args.arch:
        ap.error("--arch is required unless --front-door is given")

    run = serve_arch(args.arch, smoke=args.smoke, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen, rag=args.rag,
                     rag_docs=args.rag_docs, seed=args.seed,
                     device=args.device)
    if args.rag:
        print(f"[serve] retrieved docs per request: {run.ids.tolist()}")
    dt = run.timings["generate_s"]
    toks = args.batch * args.gen
    print(f"[serve] generated {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. the first call) on {args.device}")
    print(run.tokens.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
