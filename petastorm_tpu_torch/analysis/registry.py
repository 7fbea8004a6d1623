"""Canonical leak-guard registry: every long-lived ``pstt-*`` resource of
the port.

Counterpart of ``petastorm_tpu/analysis/registry.py``, keyed on the port's
``pstt-`` namespace. Two consumers:

* The pstlint **thread-lifecycle checker**
  (:mod:`petastorm_tpu_torch.analysis.threads`) requires every
  ``threading.Thread`` name literal in the package to resolve to a prefix
  registered here — a new background thread cannot ship without declaring
  who joins it.
* Humans: the ``rationale`` fields are the documentation of why each
  thread is allowed to exist and how it dies.

Keep this module import-light (stdlib only): the static analyzer imports
it, and must not drag in torch or pyarrow.

``action`` semantics for thread guards:

``'fail'``
    A matching thread that survives its owner is a leak (scoped by
    ``marker``; ``marker=None`` means any test).
``'note'``
    Registered and lint-checked, but not leak-failed at test granularity —
    the rationale records the lifecycle that makes a sweep wrong or
    redundant (e.g. leaks are recorded in owner ``stats()`` and asserted
    by dedicated tests, or the thread is bounded by a worker *process*).

The dir-prefix literals are duplicated from their owning modules on
purpose (this module must not import them);
``tests/test_torch_pstlint.py`` pins the values against the module
constants so they cannot drift silently.
"""


class ThreadGuard(object):
    def __init__(self, prefix, owner, rationale, marker=None, action='fail'):
        self.prefix = prefix        # thread-name prefix ('pstt-autotune')
        self.owner = owner          # module owning the thread's lifecycle
        self.marker = marker        # pytest marker scoping the sweep
        self.action = action        # 'fail' | 'note'
        self.rationale = rationale

    def __repr__(self):
        return 'ThreadGuard({!r}, action={!r})'.format(self.prefix,
                                                       self.action)


class DirGuard(object):
    def __init__(self, patterns, owner, rationale, marker=None, base=None):
        # glob patterns relative to tempfile.gettempdir(), or to ``base``
        # when the guarded resource lives elsewhere (/dev/shm for the
        # wire's POSIX shm segments)
        self.patterns = tuple(patterns)
        self.owner = owner
        self.marker = marker
        self.base = base
        self.rationale = rationale

    def __repr__(self):
        return 'DirGuard({!r})'.format(self.patterns)


THREAD_GUARDS = (
    ThreadGuard(
        'pstt-autotune', 'petastorm_tpu_torch.autotune',
        'AutoTuner.stop() joins; a leaked tuner keeps resizing a pool '
        'whose owner is gone. Armable by any factory knob or the '
        'PSTT_AUTOTUNE env.', action='fail'),
    ThreadGuard(
        'pstt-metrics-exporter', 'petastorm_tpu_torch.metrics',
        'MetricsExporter.stop() closes the listener; a leak holds a port '
        'and a registry reference.', action='fail'),
    ThreadGuard(
        'pstt-mem-governor', 'petastorm_tpu_torch.membudget',
        'Refcount-armed process-wide sampler: every pipeline built while '
        'PSTT_HOST_MEM_BUDGET is set takes an arm reference and releases '
        'it at teardown; the last release joins the thread.',
        action='fail'),
    ThreadGuard(
        'pstt-lineage-writer', 'petastorm_tpu_torch.lineage',
        'LineageLedger.close() joins the write-behind drain; a leak holds '
        'the ledger file open.', marker='lineage', action='fail'),
    ThreadGuard(
        'pstt-chunk-store-writer', 'petastorm_tpu_torch.chunk_store',
        'DecodedChunkStore.close() drains and joins the spill writer; a '
        'leaked writer keeps appending decoded chunks.',
        marker='chunkstore', action='fail'),
    ThreadGuard(
        'pstt-staging', 'petastorm_tpu_torch.staging',
        'StagingEngine.stop() joins with a timeout and RECORDS leaks in '
        'stats()["leaked_threads"] (a copy hung on a wedged card is '
        'deliberately survivable).', action='note'),
    ThreadGuard(
        'pstt-ventilator', 'petastorm_tpu_torch.workers.ventilator',
        'Daemon; completes when ventilation finishes and is joined via '
        'Ventilator.stop() on every pool stop path.', action='note'),
    ThreadGuard(
        'pstt-watchdog', 'petastorm_tpu_torch.health',
        'Watchdog.stop() joins; owned by Reader/TorchLoader teardown.',
        action='note'),
    ThreadGuard(
        'pstt-data-service', 'petastorm_tpu_torch.data_service',
        'Daemon serve/rpc/lease/client loops bounded by DataServer.close() '
        'and RemoteReader.stop().', action='note'),
    ThreadGuard(
        'pstt-lookup', 'petastorm_tpu_torch.serving.server',
        'Lookup-tier rpc/worker/lease threads (pstt-lookup-rpc, '
        'pstt-lookup-worker-<i>, pstt-lookup-lease) are daemons joined by '
        'LookupServer.stop().', marker='serving', action='fail'),
    ThreadGuard(
        'pstt-fleet-scatter', 'petastorm_tpu_torch.serving.client',
        'Per-partition scatter-gather workers of LookupClient — daemons '
        'joined before the scattering call returns.',
        marker='fleet', action='fail'),
    ThreadGuard(
        'pstt-fleet-registry', 'petastorm_tpu_torch.fleet.registry',
        'FleetRegistry.watch() SUB loop folding worker heartbeats into '
        'membership; stop() joins.', marker='fleet', action='fail'),
    ThreadGuard(
        'pstt-fleet-autoscaler', 'petastorm_tpu_torch.fleet.autoscaler',
        'FleetAutoscaler.start() control loop (and its bounded announce '
        'readers); stop() joins.', marker='fleet', action='fail'),
    ThreadGuard(
        'pstt-pool-worker', 'petastorm_tpu_torch.workers.thread_pool',
        'Daemon pool workers joined by ThreadPool.join(); retirement '
        'between items is the resize contract.', action='note'),
    ThreadGuard(
        'pstt-orphan-watch', 'petastorm_tpu_torch.workers.process_pool',
        'Lives inside a spawned worker process only (kills it when the '
        'parent dies); never present in the parent process.',
        action='note'),
    ThreadGuard(
        'pstt-bench', 'petastorm_tpu_torch.bench',
        'The bench\'s helper threads (a restarter, the fleet dance, the '
        'server log drains); each is joined by the phase that started '
        'it.', action='note'),
)

DIR_GUARDS = (
    DirGuard(
        ('pstt-chunk-store-*',), 'petastorm_tpu_torch.chunk_store',
        'Env-armed readers create prefix-named stores under the tempdir; '
        'a test dying mid-write must not leave decoded chunks behind.',
        marker='chunkstore'),
    DirGuard(
        ('pstt-lineage-*',), 'petastorm_tpu_torch.lineage',
        'Ledgers created without an explicit directory land under the '
        'tempdir with the pstt-lineage- prefix.', marker='lineage'),
    DirGuard(
        ('pst-flight-*',), 'petastorm_tpu_torch.flight_recorder',
        'Flight-recorder dump dirs (the JAX package\'s prefix, so one '
        'sweep covers both packages\' dumps).', marker='observability'),
    DirGuard(
        ('pstt-wire-*',), 'petastorm_tpu_torch.fleet.wire',
        'Per-consumer shm segment rings of the negotiated data-plane wire '
        'live under /dev/shm; servers unlink them on release/stop and '
        'sweep stale ones at start.', marker='wire', base='/dev/shm'),
)


def thread_prefixes():
    """All registered thread-name prefixes (the thread-lifecycle checker's
    allow-list)."""
    return tuple(g.prefix for g in THREAD_GUARDS)
