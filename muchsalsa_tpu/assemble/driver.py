"""Top-level assembly driver — the 11-phase pipeline.

Reference counterpart: ``main()`` (``src/main.cpp:130-322``).  Phase map:

  ① PAF ingest + match dedup           (BlastFileReader / MatchMap)
  ② scaffold all-pairs -> edges        (MatchMap::calculateEdges)
  ③ chaining + overlap classification  (chainingAndOverlaps, main.cpp:328-414)
  ④ contraction edge discovery         (findContractionEdges)
  ⑤ contraction targets / deletables   (findContractionTargets/...)
  ⑥ contract + delete + prune orders   (contract/findDeletableEdges)
  ⑦ bitweight                          (computeBitweight)
  ⑧ maximum spanning tree              (getMaxSpanTree)
  ⑨ decycle                            (decycle)
  ⑩ connected components               (getConnectedComponents)
  ⑪ per-component orient + linearize + consensus (assemblePaths)

The reference runs phases as thread-pool job fan-outs over shared
mutable state; here each phase is a deterministic sweep (the hot phase ③
batches onto the device via ``ops.chaining_jax`` when available).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from muchsalsa_tpu.assemble import consensus
from muchsalsa_tpu.assemble import contraction as ctr
from muchsalsa_tpu.assemble import spanning
from muchsalsa_tpu.assemble.consensus import ConsensusContext, assemble_path
from muchsalsa_tpu.assemble.linearize import linearize_graph
from muchsalsa_tpu.assemble.orientation import get_directed_graph, pick_start_vertex
from muchsalsa_tpu.config import Config, DEFAULT_CONFIG
from muchsalsa_tpu.graph.graph import Graph, VertexInfo
from muchsalsa_tpu.io.fasta import SequenceStore
from muchsalsa_tpu.io.output import BufferedOutputWriter, OutputWriter
from muchsalsa_tpu.io.paf import read_paf
from muchsalsa_tpu.io.registry import Registry
from muchsalsa_tpu.matching.edges import build_edges
from muchsalsa_tpu.matching.store import EdgeMatches, MatchStore
from muchsalsa_tpu.ops.chaining import GatheredMatches, max_pairwise_paths
from muchsalsa_tpu.ops.overlap import get_overlap
from muchsalsa_tpu.utils.timing import StageTimer


def build_graph(store: MatchStore, edge_matches: EdgeMatches) -> Graph:
    graph = Graph()
    for i, vid in enumerate(store.vertex_ids):
        graph.add_vertex(
            VertexInfo(
                int(vid),
                int(store.vertex_length[i]),
                int(store.vertex_meta_line[i]),
            )
        )
    for e in range(edge_matches.n_edges):
        edge = graph.add_edge(int(edge_matches.edge_v[e]), int(edge_matches.edge_w[e]))
        edge.em_idx = e
    return graph


def chain_edge(ctx, wiggle_room: int):
    """main.cpp:328-414 — returns (shadow, orders)."""
    k = len(ctx.illu_ids)
    plus_rows = np.array([i for i in range(k) if ctx.em_dir[i]], dtype=np.int64)
    minus_rows = np.array([i for i in range(k) if not ctx.em_dir[i]], dtype=np.int64)

    minus_paths = max_pairwise_paths(ctx, minus_rows, False, wiggle_room)
    plus_paths = max_pairwise_paths(ctx, plus_rows, True, wiggle_room)

    has_primary = any(p.primary for p in plus_paths) or any(p.primary for p in minus_paths)
    if has_primary:
        plus_paths = [p for p in plus_paths if p.primary]
        minus_paths = [p for p in minus_paths if p.primary]

    has_multi = any(len(p.ids) > 1 for p in plus_paths) or any(
        len(p.ids) > 1 for p in minus_paths
    )
    if has_multi:
        plus_paths = [p for p in plus_paths if len(p.ids) > 1]
        minus_paths = [p for p in minus_paths if len(p.ids) > 1]

    combined = len(plus_paths) + len(minus_paths)
    if combined > 1:
        shadow = True
    else:
        path = minus_paths[0] if minus_paths else plus_paths[0]
        shadow = not path.primary

    orders = []
    for p in minus_paths:
        o = get_overlap(ctx, p.ids, False, p.score, p.primary)
        if o is not None:
            orders.append(o)
    for p in plus_paths:
        o = get_overlap(ctx, p.ids, True, p.score, p.primary)
        if o is not None:
            orders.append(o)
    return shadow, orders


def chaining_phase(
    graph: Graph, store: MatchStore, edge_matches: EdgeMatches, wiggle_room: int
) -> None:
    gathered = GatheredMatches.build(store, edge_matches)
    for edge in graph.edges():
        ctx = gathered.context(store, edge_matches, edge.em_idx)
        shadow, orders = chain_edge(ctx, wiggle_room)
        edge.shadow = shadow
        edge.orders.extend(orders)


_ASM_STATE: dict | None = None
# per-WORKER cache of post-linearization digraphs (component idx -> dig)
_WORKER_DIGS: dict = {}


def _assembly_worker_count(workers: int | None, n_components: int) -> int:
    import multiprocessing as _mp
    import os as _os

    if n_components < 1:
        return 1
    # never nest pools: a spawn worker re-importing an unguarded user
    # script could otherwise recursively fan out
    if _mp.parent_process() is not None:
        return 1
    env = _os.environ.get("MS_TPU_ASSEMBLY_WORKERS")
    if env is not None:
        return max(1, int(env))
    if workers is None:
        # default OFF: the spawn fan-out lost every wall-clock
        # measurement taken so far (fork-COW over the multi-GB heap
        # outweighed the compute win on 2-core hosts; not yet measured
        # on a many-core host), so an implicit cpu_count fan-out is a
        # footgun.  Opt in via the `threads` CLI positional / `workers`
        # arg / MS_TPU_ASSEMBLY_WORKERS once measured on the target
        # host.  (The reference defaults to hardware_concurrency,
        # src/Application.cpp:45 — but its threads share one heap.)
        return 1
    return max(1, workers)


def _component_dig_and_paths(comp_idx: int):
    """Build (and cache) a component's post-linearization digraph."""
    st = _ASM_STATE
    graph = st["graph"]
    lcfg = st["lcfg"]
    sub = graph.subgraph(st["components"][comp_idx])
    start = pick_start_vertex(sub)
    if start is None:
        return None, []
    dig = get_directed_graph(graph, sub, start)
    paths = linearize_graph(
        dig,
        lcfg.cluster_weight_exact_max_order,
        lcfg.path_min_length,
        lcfg.path_min_length_touching,
        lcfg.join_max_distance,
    )
    _WORKER_DIGS[comp_idx] = (dig, paths)
    return dig, paths


def _linearize_component(comp_idx: int):
    """Pool phase A: orientation + linearization of one component;
    returns the (small) path lists, keeps the digraph worker-local."""
    _, paths = _component_dig_and_paths(comp_idx)
    return paths


def _assemble_component_buffered(task):
    """Pool phase B: consensus of ALL of one component's paths into
    in-memory buffers.

    The worker reuses its phase-A digraph when it has one for this
    component, otherwise deterministically rebuilds it once
    (linearization is a pure function of the shared graph, so the
    rebuilt digraph is identical).  Final assembly indices are fixed
    before the fan-out.
    """
    comp_idx, indexed_paths = task
    st = _ASM_STATE
    cached = _WORKER_DIGS.get(comp_idx)
    dig = cached[0] if cached else _component_dig_and_paths(comp_idx)[0]
    consensus.reset_fallback_counts()
    out = []
    for asm_idx, path in indexed_paths:
        bw = BufferedOutputWriter()
        assemble_path(st["ctx"], {}, st["contain"], path, dig, asm_idx, bw)
        out.append((asm_idx, *bw.texts()))
    return out, dict(consensus.FALLBACK_COUNTS)


def _asm_pool_init() -> None:
    # forked workers inherit the parent's initialized jax backend; their
    # interpreter-shutdown atexit would run jax's teardown against the
    # shared device connection. Workers are pure Python — drop it all.
    import atexit

    atexit._clear()
    _WORKER_DIGS.clear()


def _asm_spawn_init(state_path: str) -> None:
    # shared-nothing worker: explicit state handoff via one pickle load
    # (no fork-COW over the parent heap, no fork-in-threaded-process
    # deprecation)
    import pickle

    global _ASM_STATE
    with open(state_path, "rb") as fh:
        _ASM_STATE = pickle.load(fh)
    _WORKER_DIGS.clear()


def _make_assembly_pool(n_workers: int, state: dict, tmp_dir):
    """Worker pool for the assembly fan-out.  Start method comes from
    ``MS_TPU_ASSEMBLY_START`` (default ``spawn``): spawn workers are
    shared-nothing (state shipped by pickle once per worker), fork
    workers inherit the heap copy-on-write (cheaper on hosts with
    ordinary DRAM bandwidth, but deprecated in threaded parents)."""
    import multiprocessing
    import os
    import pickle
    import warnings

    method = os.environ.get("MS_TPU_ASSEMBLY_START", "spawn")
    if method == "spawn":
        # spawn re-imports __main__ in every worker; a parent whose
        # __main__ is not an importable file (python - <<EOF, embedded
        # interpreters) would crash-loop the pool — use fork there
        import sys

        main_file = getattr(sys.modules.get("__main__"), "__file__", None)
        if main_file is not None and not os.path.isfile(main_file):
            method = "fork"
    if method == "fork" and "fork" in multiprocessing.get_all_start_methods():
        mp_ctx = multiprocessing.get_context("fork")
        with warnings.catch_warnings():
            # CPython warns that fork + jax's threads may deadlock; the
            # workers are pure Python and never touch jax (atexit is
            # cleared in the initializer), so the fork is safe here
            warnings.filterwarnings(
                "ignore", message=".*fork.*", category=RuntimeWarning)
            return mp_ctx.Pool(n_workers, initializer=_asm_pool_init)
    state_path = os.path.join(tmp_dir, "asm_state.pkl")
    with open(state_path, "wb") as fh:
        pickle.dump(state, fh, protocol=5)
    mp_ctx = multiprocessing.get_context("spawn")
    return mp_ctx.Pool(
        n_workers, initializer=_asm_spawn_init, initargs=(state_path,))


def _run_parallel_assembly(
    ctx, contain_elements, graph, components, lcfg, n_workers, writer
) -> int:
    """Two pool phases mirroring the reference's job-per-component +
    subjob-per-path fan-out (src/main.cpp:303-310, 645-657): A)
    orientation+linearization per component (returns path lists), B)
    consensus per path (returns output buffers, written in path order —
    byte-identical to the sequential loop)."""
    import tempfile

    global _ASM_STATE
    _ASM_STATE = {
        "ctx": ctx, "contain": contain_elements, "graph": graph,
        "components": components, "lcfg": lcfg,
    }
    try:
        with tempfile.TemporaryDirectory(prefix="ms_asm_") as tmp_dir:
            pool = _make_assembly_pool(n_workers, _ASM_STATE, tmp_dir)
            with pool:
                per_comp = pool.map(
                    _linearize_component, range(len(components)), chunksize=1)
                tasks = []
                asm_idx = -1
                for comp_idx, paths in enumerate(per_comp):
                    indexed = []
                    for path in paths:
                        asm_idx += 1
                        indexed.append((asm_idx, path))
                    if indexed:
                        tasks.append((comp_idx, indexed))
                # heaviest components first: the largest sets the
                # critical path
                order = sorted(
                    range(len(tasks)),
                    key=lambda i: -sum(len(p) for _a, p in tasks[i][1]))
                results = pool.map(
                    _assemble_component_buffered, [tasks[i] for i in order],
                    chunksize=1)
        n_paths = asm_idx + 1
        by_idx = {}
        for out, counts in results:
            for a_idx, q, p, t in out:
                by_idx[a_idx] = (q, p, t)
            for name, value in counts.items():
                consensus.FALLBACK_COUNTS[name] += value
        for i in range(n_paths):
            q, p, t = by_idx[i]
            writer.write_query(q)
            writer.write_paf(p)
            writer.write_target(t)
        return n_paths
    finally:
        _ASM_STATE = None


def _run_distributed_assembly(
    ctx, contain_elements, graph, components, lcfg, writer,
    process_index: int, process_count: int, allgather,
) -> int:
    """Cross-PROCESS component fan-out (SURVEY.md §2.5 row 4 — the
    multi-host form of ``src/main.cpp:303-310``): components round-robin
    over jax processes, every process linearizes and assembles its
    share into in-memory buffers, path lists and buffers cross the
    network through ``allgather`` (``jax_record_allgather``-shaped:
    list in, merged list out), and every process writes the identical
    merged output in global path order — byte-equal to the sequential
    loop.  Graph phases before this point are deterministic replicas in
    each process, so only path lists and output buffers ever cross the
    wire."""
    global _ASM_STATE
    _ASM_STATE = {
        "ctx": ctx, "contain": contain_elements, "graph": graph,
        "components": components, "lcfg": lcfg,
    }
    try:
        _WORKER_DIGS.clear()
        mine = [i for i in range(len(components))
                if i % process_count == process_index]
        local_paths = [(i, _linearize_component(i)) for i in mine]
        merged = allgather(local_paths)
        paths_by_comp = dict(merged)

        # deterministic global assembly indices in component order
        asm_idx = -1
        tasks = {}
        for comp_idx in range(len(components)):
            indexed = []
            for path in paths_by_comp.get(comp_idx, []):
                asm_idx += 1
                indexed.append((asm_idx, path))
            if indexed:
                tasks[comp_idx] = indexed
        n_paths = asm_idx + 1

        local_out = []
        for comp_idx in mine:
            if comp_idx in tasks:
                out, counts = _assemble_component_buffered(
                    (comp_idx, tasks[comp_idx]))
                local_out.append((out, counts))
        gathered = allgather(local_out)

        consensus.reset_fallback_counts()
        by_idx = {}
        for out, counts in gathered:
            for a_idx, q, p, t in out:
                by_idx[a_idx] = (q, p, t)
            for name, value in counts.items():
                consensus.FALLBACK_COUNTS[name] += value
        for i in range(n_paths):
            q, p, t = by_idx[i]
            writer.write_query(q)
            writer.write_paf(p)
            writer.write_target(t)
        return n_paths
    finally:
        _ASM_STATE = None


def _backend_is_cpu() -> bool:
    """Compiles on the CPU backend are cheap, so the size gates on the
    device phases apply only to accelerators."""
    import jax

    return jax.default_backend() == "cpu"


def _driver_mesh(config: Config, local_only: bool = False):
    """Data-parallel mesh over all attached devices (None when a single
    device is attached) — the driver-side sizing that mirrors the
    reference sizing its whole run by the thread pool (main.cpp:144).

    ``local_only``: under jax.distributed the graph phases are
    deterministic per-process replicas (only the component fan-out
    shards), so the mesh must span only this process's addressable
    devices — a global mesh would yield arrays whose values no single
    process can fetch."""
    if not config.device.use_device:
        return None
    try:
        import jax

        devices = jax.local_devices() if local_only else jax.devices()
        if len(devices) > 1:
            from muchsalsa_tpu.parallel.mesh import make_mesh

            return make_mesh(axis=config.device.data_axis, devices=devices)
    except Exception:
        pass
    return None


def assemble(
    paf_path: str | Path,
    unitigs_path: str | Path,
    nanopore_path: str | Path,
    output_dir: str | Path,
    config: Config = DEFAULT_CONFIG,
    timer: StageTimer | None = None,
    workers: int | None = None,
    process_index: int = 0,
    process_count: int = 1,
    allgather=None,
) -> dict:
    """Run the full core assembly; returns summary counters.

    With ``process_count > 1`` (jax.distributed), the per-component
    assembly fan-out shards across processes (round-robin) and merges
    through ``allgather`` (see :func:`_run_distributed_assembly`);
    every process produces the identical byte-equal output files."""
    timer = timer or StageTimer()
    gcfg = config.graph
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)

    # debug mode: eager (jit-disabled) device path + verbose stage logs
    # — the analog of the reference's sanitizer builds (SURVEY.md §5)
    import contextlib
    import os

    debug_ctx = contextlib.nullcontext()
    if os.environ.get("MS_TPU_DEBUG"):
        import jax

        timer.verbose = True
        debug_ctx = jax.disable_jit()
    profile_dir = os.environ.get("MS_TPU_PROFILE")

    registry_nano = Registry()
    registry_illu = Registry()

    with timer.stage("ingest"):
        records = read_paf(
            paf_path,
            min_matches=gcfg.min_matches,
            th_length=gcfg.th_length,
            th_matches=gcfg.th_matches,
            skip_last_line=gcfg.skip_last_paf_line,
            registry_nanopore=registry_nano,
            registry_illumina=registry_illu,
        )
        store = MatchStore.from_paf(records)

    mesh = _driver_mesh(config, local_only=process_count > 1)
    timer.count("mesh_devices", 0 if mesh is None else mesh.size)

    # phase ② placement: large match tables run the all-pairs scaffold
    # intersection on the device (sharded over the mesh when >1 device)
    edges_on_device = config.device.use_device and (
        _backend_is_cpu()
        or config.device.edges_device_min_rows == 0
        or len(store) >= config.device.edges_device_min_rows
    )
    timer.count("edges_on_device", int(edges_on_device))
    with timer.stage("edges"):
        if edges_on_device:
            from muchsalsa_tpu.matching.edges_jax import build_edges_device

            edge_matches = build_edges_device(
                store, gcfg.th_overlap, mesh=mesh)
        else:
            edge_matches = build_edges(store, gcfg.th_overlap)
        graph = build_graph(store, edge_matches)
    timer.count("graph_order", graph.order)
    timer.count("graph_size", graph.size)

    with timer.stage("sequence_index"):
        nano_seqs = SequenceStore(registry_nano)
        nano_seqs.load(nanopore_path)
        illu_seqs = SequenceStore(registry_illu)
        illu_seqs.load(unitigs_path)

    from muchsalsa_tpu.utils.timing import jax_profile

    # per-size hybrid placement: 2*edges upper-bounds the (edge, strand)
    # problem count; small runs stay on the host oracle (below
    # config.device.chain_device_min_problems the compile is expected to
    # outweigh the device's gain)
    chain_on_device = config.device.use_device and (
        _backend_is_cpu()
        or config.device.chain_device_min_problems == 0
        or 2 * graph.size >= config.device.chain_device_min_problems
    )
    timer.count("chaining_on_device", int(chain_on_device))
    with timer.stage("chaining"), debug_ctx, jax_profile(profile_dir):
        if chain_on_device:
            from muchsalsa_tpu.ops.chaining_jax import chaining_phase_device

            chaining_phase_device(
                graph,
                store,
                edge_matches,
                gcfg.wiggle_room,
                config.device.chain_buckets,
                config.device.min_device_batch,
                mesh=mesh,
            )
        else:
            chaining_phase(graph, store, edge_matches, gcfg.wiggle_room)

    with timer.stage("contraction"):
        contraction_edges = ctr.find_contraction_edges(graph, gcfg.wiggle_room)
        targets = ctr.find_contraction_targets(graph, contraction_edges)
        deletable_vertices, roots = ctr.find_deletable_vertices(contraction_edges, targets)
        contain_elements = ctr.contract(
            contraction_edges,
            roots,
            lambda nano, illu: store.row(nano, illu),
            lambda vid: graph.vertex(vid).nanopore_length,
        )
        for vid in sorted(deletable_vertices):
            graph.delete_vertex(vid)
        for edge in ctr.prune_contained_orders(graph):
            graph.delete_edge(edge)
    timer.count("contraction_edges", len(contraction_edges))
    timer.count("contraction_roots", len(roots))

    with timer.stage("spanning"):
        spanning.compute_bitweights(graph)
        tree = spanning.max_span_tree(graph)
        for edge in spanning.decycle(
            graph,
            tree,
            gcfg.base_weight_multiplicator,
            gcfg.max_weight_multiplicator,
        ):
            graph.delete_edge(edge)
    timer.count("graph_order_reduced", graph.order)
    timer.count("graph_size_reduced", graph.size)

    consensus.reset_fallback_counts()
    with timer.stage("assembly"):
        writer = OutputWriter(
            out / "temp_1.query.fa", out / "temp_1.align.paf", out / "temp_1.target.fa"
        )
        ctx = ConsensusContext(
            store,
            edge_matches,
            nano_seqs,
            illu_seqs,
            config.consensus.th_sequence_length,
            config.consensus.sequence_line_length,
        )
        components = spanning.connected_components(graph)
        lcfg = config.linearize
        if process_count > 1 or allgather is not None:
            n_workers = 1
            n_paths = _run_distributed_assembly(
                ctx, contain_elements, graph, components, lcfg, writer,
                process_index, process_count,
                allgather if allgather is not None else (lambda x: x),
            )
        elif (n_workers := _assembly_worker_count(
                workers, len(components))) > 1:
            n_paths = _run_parallel_assembly(
                ctx, contain_elements, graph, components, lcfg, n_workers,
                writer,
            )
        else:
            # sequential: per-component orientation + linearization, then
            # per-path consensus — the reference's processing order
            # (src/main.cpp:303-310, 645-657)
            asm_idx = -1
            n_paths = 0
            for component in components:
                sub = graph.subgraph(component)
                start = pick_start_vertex(sub)
                if start is None:
                    continue
                dig = get_directed_graph(graph, sub, start)
                paths = linearize_graph(
                    dig,
                    lcfg.cluster_weight_exact_max_order,
                    lcfg.path_min_length,
                    lcfg.path_min_length_touching,
                    lcfg.join_max_distance,
                )
                for path in paths:
                    asm_idx += 1
                    n_paths += 1
                    id2overlap: dict = {}
                    assemble_path(
                        ctx, id2overlap, contain_elements, path, dig, asm_idx,
                        writer,
                    )
        writer.close()
    timer.count("assembly_workers", n_workers)
    timer.count("components", len(components))
    timer.count("paths", n_paths)
    for name, value in consensus.FALLBACK_COUNTS.items():
        timer.count(name, value)

    (out / "assembly_stats.json").write_text(timer.dump())
    return {"components": len(components), "paths": n_paths, "timer": timer}
