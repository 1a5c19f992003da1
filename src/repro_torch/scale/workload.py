"""Deterministic multi-tenant workload generation for scale storms.

The serving stack has only ever been benchmarked at 4 tenants x 300
Poisson arrivals — this module generates the other end of the spectrum:
thousands of tenants drawn from configurable *populations*, each with its
own arrival process (Poisson / bursty / heavy-tailed / diurnal), circuit
spec mix, priority tier, SLO class, and fair-share weight.  Everything is
seeded: the same ``WorkloadSpec`` always expands to the bit-identical
``Trace``, which is what lets the CI scale gate pin knee-point metrics.

The generated ``Trace`` is runtime-agnostic — ``repro_torch.scale.replay`` turns
it into ``SystemSimulation`` inputs (virtual clock, 10k+ tenants) or real
``GatewayRuntime`` submissions (small mixes, real kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ARRIVAL_KINDS = ("poisson", "bursty", "heavy_tail", "diurnal")

#: circuit shapes with calibrated paper service rates (see
#: ``repro_torch.comanager.worker.PAPER_RATES_GCP``): (qubits, layers).
KNOWN_SPECS = ((5, 1), (5, 2), (5, 3), (7, 1), (7, 2), (7, 3))


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """One tenant-level inter-arrival process, mean ``rate`` arrivals/sec.

    ``poisson``    — exponential inter-arrivals (the memoryless baseline).
    ``bursty``     — batch-Poisson: burst epochs arrive Poisson at
                     ``rate / mean_burst``; each epoch emits a geometric
                     number of circuits (mean ``mean_burst``) spaced
                     ``burst_spacing_s`` apart.  Mean rate stays ``rate``.
    ``heavy_tail`` — Lomax (Pareto-II) inter-arrivals with tail index
                     ``alpha`` (1 < alpha <= 2 has infinite variance:
                     long quiet gaps punctuated by dense runs), scaled so
                     the mean inter-arrival is ``1 / rate``.
    ``diurnal``    — inhomogeneous Poisson thinned against
                     ``rate * (1 + depth * sin(2 pi t / period_s))``: the
                     whole population ebbs and surges together.
    """

    kind: str = "poisson"
    rate: float = 1.0
    mean_burst: float = 8.0
    burst_spacing_s: float = 0.02
    alpha: float = 1.6
    period_s: float = 60.0
    depth: float = 0.8

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; valid: {ARRIVAL_KINDS}"
            )
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if self.mean_burst < 1.0:
            raise ValueError(
                f"mean_burst must be >= 1, got {self.mean_burst}"
            )
        if self.alpha <= 1.0:
            raise ValueError(
                f"alpha must be > 1 (finite mean), got {self.alpha}"
            )
        if not 0.0 <= self.depth < 1.0:
            raise ValueError(f"depth must be in [0, 1), got {self.depth}")
        if self.period_s <= 0:
            raise ValueError(
                f"period_s must be positive, got {self.period_s}"
            )

    def sample(
        self,
        rng: np.random.Generator,
        duration_s: float,
        rate: float | None = None,
    ) -> list[float]:
        """Arrival offsets in ``[0, duration_s)``, sorted ascending."""
        rate = self.rate if rate is None else rate
        n_cap = max(8, int(rate * duration_s * 4) + 16)
        if self.kind == "poisson":
            gaps = rng.exponential(1.0 / rate, n_cap)
        elif self.kind == "heavy_tail":
            scale = (self.alpha - 1.0) / rate
            gaps = rng.pareto(self.alpha, n_cap) * scale
        elif self.kind == "bursty":
            return self._sample_bursty(rng, duration_s, rate)
        else:  # diurnal: thinning against the sinusoidal envelope
            return self._sample_diurnal(rng, duration_s, rate)
        times = np.cumsum(gaps)
        return times[times < duration_s].tolist()

    def _sample_bursty(
        self, rng: np.random.Generator, duration_s: float, rate: float
    ) -> list[float]:
        epoch_rate = rate / self.mean_burst
        n_cap = max(4, int(epoch_rate * duration_s * 4) + 8)
        epochs = np.cumsum(rng.exponential(1.0 / epoch_rate, n_cap))
        epochs = epochs[epochs < duration_s]
        out: list[float] = []
        for t0 in epochs:
            size = 1 + rng.geometric(1.0 / self.mean_burst)
            for j in range(int(size)):
                t = t0 + j * self.burst_spacing_s
                if t < duration_s:
                    out.append(float(t))
        out.sort()  # long bursts can overrun the next epoch's start
        return out

    def _sample_diurnal(
        self, rng: np.random.Generator, duration_s: float, rate: float
    ) -> list[float]:
        rate_max = rate * (1.0 + self.depth)
        n_cap = max(8, int(rate_max * duration_s * 4) + 16)
        times = np.cumsum(rng.exponential(1.0 / rate_max, n_cap))
        times = times[times < duration_s]
        envelope = 1.0 + self.depth * np.sin(
            2.0 * np.pi * times / self.period_s
        )
        keep = rng.uniform(0.0, 1.0 + self.depth, times.shape) < envelope
        return times[keep].tolist()


@dataclasses.dataclass(frozen=True)
class TenantPopulation:
    """A cohort of tenants sharing an arrival process and SLO class.

    ``circuit_mix``: ``(qubits, layers, weight)`` rows — each tenant draws
    ONE circuit spec from the mix (a tenant trains one model), so spec
    diversity lives across the population.  ``rate_spread``: lognormal
    sigma of the per-tenant rate multiplier (0 = identical rates; 1.0 is a
    realistically skewed fleet where the busiest tenants dominate).
    ``priority`` / ``slo_ms`` / ``weight`` feed the gateway's strict tiers,
    deadline accounting, and weighted-fair scheduler.
    """

    name: str
    n_tenants: int
    arrival: ArrivalProcess
    circuit_mix: tuple[tuple[int, int, float], ...] = ((5, 1, 1.0),)
    priority: int = 1
    slo_ms: float | None = None
    weight: float = 1.0
    rate_spread: float = 0.0

    def __post_init__(self):
        if self.n_tenants < 1:
            raise ValueError(
                f"{self.name}: n_tenants must be >= 1, got {self.n_tenants}"
            )
        if not self.circuit_mix:
            raise ValueError(f"{self.name}: circuit_mix must be non-empty")
        for qc, nl, w in self.circuit_mix:
            if (qc, nl) not in KNOWN_SPECS:
                raise ValueError(
                    f"{self.name}: unknown circuit spec ({qc}q, {nl}l); "
                    f"calibrated specs: {list(KNOWN_SPECS)}"
                )
            if w <= 0:
                raise ValueError(
                    f"{self.name}: circuit_mix weight must be positive"
                )
        if self.rate_spread < 0:
            raise ValueError(
                f"{self.name}: rate_spread must be >= 0, got "
                f"{self.rate_spread}"
            )
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(
                f"{self.name}: slo_ms must be positive, got {self.slo_ms}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"{self.name}: weight must be positive, got {self.weight}"
            )


@dataclasses.dataclass(frozen=True)
class TenantProfile:
    """One generated tenant: identity, circuit spec, and serving policy."""

    tenant_id: str
    population: str
    qc: int
    n_layers: int
    priority: int
    slo_ms: float | None
    weight: float
    rate: float  # realized mean arrivals/sec (after spread + load)


@dataclasses.dataclass
class Trace:
    """A generated storm: tenant profiles + per-tenant arrival offsets.

    ``arrivals[tenant_id]`` are offsets (seconds) into the storm window;
    tenants that drew zero arrivals in the window are omitted.
    """

    duration_s: float
    seed: int
    load: float
    tenants: list[TenantProfile]
    arrivals: dict[str, list[float]]

    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def n_circuits(self) -> int:
        return sum(len(a) for a in self.arrivals.values())

    @property
    def offered_cps(self) -> float:
        return self.n_circuits / max(self.duration_s, 1e-9)

    def summary(self) -> dict:
        by_pop: dict[str, int] = {}
        for t in self.tenants:
            by_pop[t.population] = by_pop.get(t.population, 0) + 1
        return {
            "n_tenants": self.n_tenants,
            "n_circuits": self.n_circuits,
            "duration_s": self.duration_s,
            "offered_cps": round(self.offered_cps, 2),
            "load": self.load,
            "seed": self.seed,
            "tenants_by_population": dict(sorted(by_pop.items())),
        }


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A seeded storm recipe: populations + window + offered-load scale.

    ``load`` multiplies every tenant's arrival rate — the knob the knee
    sweep turns.  ``generate()`` is a pure function of the spec: the same
    (populations, duration, seed, load) always yields the same trace.
    """

    populations: tuple[TenantPopulation, ...]
    duration_s: float = 20.0
    seed: int = 0
    load: float = 1.0

    def __post_init__(self):
        if not self.populations:
            raise ValueError("populations must be non-empty")
        names = [p.name for p in self.populations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate population names in {names}")
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be positive, got {self.duration_s}"
            )
        if self.load <= 0:
            raise ValueError(f"load must be positive, got {self.load}")
        if not isinstance(self.populations, tuple):
            object.__setattr__(self, "populations", tuple(self.populations))

    @property
    def n_tenants_nominal(self) -> int:
        return sum(p.n_tenants for p in self.populations)

    def at_load(self, load: float) -> "WorkloadSpec":
        return dataclasses.replace(self, load=load)

    def generate(self) -> Trace:
        rng = np.random.default_rng(self.seed)
        tenants: list[TenantProfile] = []
        arrivals: dict[str, list[float]] = {}
        for pop in self.populations:
            mix = np.asarray([w for _, _, w in pop.circuit_mix], float)
            mix /= mix.sum()
            for i in range(pop.n_tenants):
                tid = f"{pop.name}-{i:05d}"
                spec_i = int(rng.choice(len(pop.circuit_mix), p=mix))
                qc, nl, _ = pop.circuit_mix[spec_i]
                mult = 1.0
                if pop.rate_spread > 0:
                    sigma = pop.rate_spread
                    # mean-1 lognormal: the population's aggregate rate is
                    # load-invariant under spread
                    mult = float(
                        rng.lognormal(-0.5 * sigma * sigma, sigma)
                    )
                rate = pop.arrival.rate * mult * self.load
                offsets = pop.arrival.sample(rng, self.duration_s, rate)
                if not offsets:
                    continue  # silent tenant this window
                tenants.append(
                    TenantProfile(
                        tenant_id=tid,
                        population=pop.name,
                        qc=qc,
                        n_layers=nl,
                        priority=pop.priority,
                        slo_ms=pop.slo_ms,
                        weight=pop.weight,
                        rate=rate,
                    )
                )
                arrivals[tid] = offsets
        return Trace(
            duration_s=self.duration_s,
            seed=self.seed,
            load=self.load,
            tenants=tenants,
            arrivals=arrivals,
        )


def standard_populations(
    n_tenants: int,
    *,
    rate_per_tenant: float = 0.4,
    slo_scale: float = 1.0,
) -> tuple[TenantPopulation, ...]:
    """The canonical three-class storm mix at ``n_tenants`` total.

    15% interactive (tier 0, tight SLO, Poisson), 55% batch (tier 1,
    relaxed SLO, heavy-tailed), 30% bursty best-effort (tier 2, loose SLO,
    batch-Poisson bursts + diurnal surge).  ``rate_per_tenant`` sets the
    per-tenant mean arrival rate at load 1.0.
    """
    n_interactive = max(1, int(n_tenants * 0.15))
    n_bursty = max(1, int(n_tenants * 0.30))
    n_batch = max(1, n_tenants - n_interactive - n_bursty)
    return (
        TenantPopulation(
            name="interactive",
            n_tenants=n_interactive,
            arrival=ArrivalProcess(kind="poisson", rate=rate_per_tenant),
            circuit_mix=((5, 1, 3.0), (7, 1, 1.0)),
            priority=0,
            slo_ms=2000.0 * slo_scale,
            weight=4.0,
        ),
        TenantPopulation(
            name="batch",
            n_tenants=n_batch,
            arrival=ArrivalProcess(
                kind="heavy_tail", rate=rate_per_tenant, alpha=1.6
            ),
            circuit_mix=((5, 1, 2.0), (5, 2, 1.0), (7, 1, 2.0), (7, 2, 1.0)),
            priority=1,
            slo_ms=8000.0 * slo_scale,
            weight=1.0,
            rate_spread=0.8,
        ),
        TenantPopulation(
            name="bursty",
            n_tenants=n_bursty,
            arrival=ArrivalProcess(
                kind="bursty", rate=rate_per_tenant, mean_burst=6.0
            ),
            circuit_mix=((5, 1, 1.0), (7, 1, 1.0)),
            priority=2,
            slo_ms=16000.0 * slo_scale,
            weight=0.5,
        ),
    )


__all__ = [
    "ARRIVAL_KINDS",
    "ArrivalProcess",
    "KNOWN_SPECS",
    "TenantPopulation",
    "TenantProfile",
    "Trace",
    "WorkloadSpec",
    "standard_populations",
]
