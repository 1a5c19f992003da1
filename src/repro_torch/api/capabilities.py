"""Capability declaration for circuit-bank executors.

This is the vocabulary of the ``ExecutionBackend`` protocol
(``repro.api.backend``): instead of duck-typed ``accepts_shiftbank`` /
``accepts_bankset`` attribute probes scattered through ``core``,
``comanager`` and ``serve``, an executor DECLARES what it can consume and
every dispatch site asks ``capabilities_of``.  Legacy callables that still
carry only the old attributes keep working through the single deprecation
shim at the bottom of ``capabilities_of`` — the one place in the codebase
where the old attribute probes survive.

This module is intentionally dependency-free (no jax, no other ``repro``
imports): ``repro.core.shift_rule`` imports it at module scope, while
``repro.api.backend`` imports ``repro.core.shift_rule`` — keeping this file
a leaf is what makes that cycle-free.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What an executor/backend can consume natively.

    ``shiftbank``: executes implicit ``shift_rule.ShiftBank``s directly
    (the prefix-reuse kernel path) — called as ``run(bank)``.

    ``multibank``: fuses whole same-spec BANK SETS into shared launches —
    called as ``run([bank, ...]) -> [fids, ...]`` (``run_bank_set``).

    ``sharded``: execution shards over a device mesh (``shard_map``), so
    lane working sets divide across devices.

    ``vmem_model``: the backend's cost model reports a post-spill
    per-device VMEM footprint (the kernel's depth-tiled checkpoint
    spilling keeps it bounded), so dispatchers may budget against it.

    ``mesh_spill``: oversized work (register width or VMEM working set
    above any single worker) reroutes to the whole mesh instead of
    failing fast.
    """

    shiftbank: bool = False
    multibank: bool = False
    sharded: bool = False
    vmem_model: bool = False
    mesh_spill: bool = False


#: the empty declaration: only materialized ``(theta, data)`` row batches.
MATERIALIZED_ONLY = Capabilities()


def declare(executor, **caps):
    """Attach declared ``Capabilities`` to a callable executor.

    The legacy ``accepts_shiftbank`` / ``accepts_bankset`` duck-typing
    attributes are mirrored for not-yet-migrated callers (they are
    attributes, not probes — reading capabilities via ``getattr`` belongs
    exclusively to the ``capabilities_of`` shim).  Returns the executor so
    factories can ``return declare(run, shiftbank=True)``.
    """
    c = Capabilities(**caps)
    executor.capabilities = c
    executor.accepts_shiftbank = c.shiftbank
    executor.accepts_bankset = c.multibank
    return executor


def capabilities_of(executor) -> Capabilities:
    """Resolve an executor's declared capabilities.

    Declared capabilities win: a ``capabilities`` attribute holding either
    a ``Capabilities`` instance (``declare``-d callables) or a zero-arg
    method returning one (``ExecutionBackend`` objects).  Anything else
    falls through to the DEPRECATION SHIM — the single surviving
    duck-typed probe of the old ``accepts_shiftbank`` / ``accepts_bankset``
    attributes, which keeps pre-protocol executors working unchanged.
    """
    cap = getattr(executor, "capabilities", None)
    if callable(cap):
        cap = cap()
    if isinstance(cap, Capabilities):
        return cap
    # deprecation shim: the ONE place the legacy attribute probes remain.
    return Capabilities(
        shiftbank=bool(getattr(executor, "accepts_shiftbank", False)),
        multibank=bool(getattr(executor, "accepts_bankset", False)),
    )
