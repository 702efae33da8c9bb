"""Campaign DSL: seeded, trace-driven serving traffic as data
(counterpart of distribuuuu_tpu/serve/campaign/dsl.py: the same parse, the
same numpy draws in the same order, so a schedule hashes bitwise equal to
the JAX package's).

A campaign YAML declares WHAT traffic a fleet must survive — not code:

.. code-block:: yaml

    campaign: 1
    name: flash_crowd
    seed: 23
    interval_s: 1.0
    models:
      - {name: resnet18, slo_class: standard, p99_slo_ms: 400}
    rules:
      - {kind: p99-breach, threshold: 350.0, window_s: 2, min_steps: 4}
    phases:
      - {name: control, kind: steady, duration_s: 6, rate_rps: 3,
         expect: []}
      - {name: crowd, kind: flash, duration_s: 10, rate_rps: 3,
         burst_x: 40, burst_window: [0.3, 0.7],
         expect: [p99-breach, backpressure]}

``build_schedule(spec)`` turns the spec into an explicit request
schedule — a list of ``(t_seconds, model, size)`` tuples — via an
inhomogeneous-Poisson thinning sampler over a per-phase rate curve,
driven ONLY by ``numpy.random.default_rng(seed)``. Same YAML + same
seed ⇒ byte-identical schedule (``schedule_hash`` pins this, and
tests/test_torch_campaign.py holds it to the JAX package's); the runner
replays it open-loop against a real fleet, so a campaign is a
reproducible experiment, not a load-test vibe.

Phase kinds (rate curves over phase-relative u ∈ [0, 1)):

* ``steady``         — constant ``rate_rps`` (control phases).
* ``diurnal``        — raised-cosine trough→peak→trough between
                       ``rate_rps`` and ``peak_rps`` (one "day").
* ``flash``          — ``rate_rps`` with a ``burst_x`` multiplier
                       inside ``burst_window`` (flash crowd).
* ``heavy_tail``     — steady rate, Pareto(``size_alpha``) request
                       sizes clamped to ``size_max`` (a "request" of
                       size k is k back-to-back dispatches: the
                       heavy-tail work-size mix).
* ``rolling_update`` — steady rate; the runner triggers
                       ``update`` (model weight swap via draining
                       restarts) at ``at_frac`` of the phase.

Each phase carries ``expect`` — the exact alert-kind set the rule
engine must raise during that phase (empty for control). The runner
scores raised == expected per phase; exact match is the verdict.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import numpy as np

PHASE_KINDS = ("steady", "diurnal", "flash", "heavy_tail", "rolling_update")

# rule kinds a campaign may arm: the runner builds serve-shaped
# snapshots (no training plane), so only serve-evaluable kinds make
# sense here. Validated at load so a typo fails the spec, not the run.
CAMPAIGN_RULE_KINDS = (
    "p99-breach",
    "backpressure",
    "slo-breach",
    "degrade-spill",
    "recompile-storm",
)

_PHASE_KEYS = {
    "name", "kind", "duration_s", "rate_rps", "expect", "mix",
    "peak_rps", "burst_x", "burst_window", "size_alpha", "size_max",
    "update", "at_frac",
}
_MODEL_KEYS = {"name", "slo_class", "p99_slo_ms", "overflow_to"}
_SPEC_KEYS = {"campaign", "name", "seed", "interval_s", "models",
              "rules", "phases"}


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    name: str
    kind: str
    duration_s: float
    rate_rps: float
    expect: tuple
    mix: tuple  # ((model, weight), ...) — normalized at load
    peak_rps: float = 0.0
    burst_x: float = 1.0
    burst_window: tuple = (0.0, 0.0)
    size_alpha: float = 1.5
    size_max: int = 8
    update: dict | None = None
    at_frac: float = 0.25


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    name: str
    seed: int
    interval_s: float
    models: tuple   # (dict(name, slo_class, p99_slo_ms, overflow_to), ...)
    rules: tuple    # raw AlertRule spec dicts (fed to live.AlertRule)
    phases: tuple   # (PhaseSpec, ...)

    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)


def _mix_for(raw_mix, models) -> tuple:
    names = [m["name"] for m in models]
    if raw_mix is None:
        raw_mix = {names[0]: 1.0}
    unknown = sorted(set(raw_mix) - set(names))
    if unknown:
        raise ValueError(
            f"phase mix references unknown models {unknown}; declared: {names}"
        )
    total = float(sum(raw_mix.values()))
    if total <= 0:
        raise ValueError("phase mix weights must sum > 0")
    return tuple((m, float(w) / total) for m, w in sorted(raw_mix.items()))


def parse_campaign(doc: dict) -> CampaignSpec:
    """Validate a parsed campaign YAML document into a CampaignSpec.

    Strict like telemetry's AlertRule: unknown keys, unknown phase
    kinds, and unknown expect/rule kinds are errors — a campaign that
    silently ignores a typoed gate is worse than no campaign.
    """
    if not isinstance(doc, dict) or doc.get("campaign") != 1:
        raise ValueError("campaign YAML must set 'campaign: 1'")
    unknown = sorted(set(doc) - _SPEC_KEYS)
    if unknown:
        raise ValueError(f"unknown campaign keys: {unknown}")
    models = []
    for m in doc.get("models") or []:
        bad = sorted(set(m) - _MODEL_KEYS)
        if bad:
            raise ValueError(f"unknown model keys: {bad}")
        if not m.get("name"):
            raise ValueError("each campaign model needs a name")
        models.append({
            "name": str(m["name"]),
            "slo_class": str(m.get("slo_class", "standard")),
            "p99_slo_ms": (None if m.get("p99_slo_ms") is None
                           else float(m["p99_slo_ms"])),
            "overflow_to": m.get("overflow_to"),
        })
    if not models:
        raise ValueError("campaign needs at least one model")
    names = {m["name"] for m in models}
    for m in models:
        if m["overflow_to"] is not None and m["overflow_to"] not in names:
            raise ValueError(
                f"model {m['name']!r} overflows to undeclared "
                f"{m['overflow_to']!r}"
            )

    rules = tuple(dict(r) for r in doc.get("rules") or [])
    for r in rules:
        if r.get("kind") not in CAMPAIGN_RULE_KINDS:
            raise ValueError(
                f"campaign rule kind {r.get('kind')!r} not in "
                f"{CAMPAIGN_RULE_KINDS}"
            )

    phases = []
    for p in doc.get("phases") or []:
        bad = sorted(set(p) - _PHASE_KEYS)
        if bad:
            raise ValueError(f"unknown phase keys: {bad}")
        kind = p.get("kind")
        if kind not in PHASE_KINDS:
            raise ValueError(f"unknown phase kind {kind!r}; one of {PHASE_KINDS}")
        expect = tuple(p.get("expect") or ())
        bad_expect = sorted(set(expect) - set(CAMPAIGN_RULE_KINDS))
        if bad_expect:
            raise ValueError(
                f"phase {p.get('name')!r} expects un-armable kinds {bad_expect}"
            )
        armed = {r["kind"] for r in rules}
        missing = sorted(set(expect) - armed)
        if missing:
            raise ValueError(
                f"phase {p.get('name')!r} expects {missing} but the "
                f"campaign arms only {sorted(armed)}"
            )
        if kind == "rolling_update":
            upd = p.get("update") or {}
            if upd.get("model") not in names:
                raise ValueError(
                    "rolling_update phase needs update.model ∈ declared models"
                )
        bw = p.get("burst_window", (0.3, 0.7))
        phases.append(PhaseSpec(
            name=str(p.get("name", kind)),
            kind=kind,
            duration_s=float(p["duration_s"]),
            rate_rps=float(p["rate_rps"]),
            expect=expect,
            mix=_mix_for(p.get("mix"), models),
            peak_rps=float(p.get("peak_rps", 0.0)),
            burst_x=float(p.get("burst_x", 1.0)),
            burst_window=(float(bw[0]), float(bw[1])),
            size_alpha=float(p.get("size_alpha", 1.5)),
            size_max=int(p.get("size_max", 8)),
            update=p.get("update"),
            at_frac=float(p.get("at_frac", 0.25)),
        ))
    if not phases:
        raise ValueError("campaign needs at least one phase")

    return CampaignSpec(
        name=str(doc.get("name", "campaign")),
        seed=int(doc.get("seed", 0)),
        interval_s=float(doc.get("interval_s", 1.0)),
        models=tuple(models),
        rules=rules,
        phases=tuple(phases),
    )


def load_campaign(path: str) -> CampaignSpec:
    import yaml

    with open(path) as f:
        return parse_campaign(yaml.safe_load(f))


def _rate(phase: PhaseSpec, u: float) -> float:
    """Instantaneous arrival rate (rps) at phase-relative u ∈ [0, 1)."""
    if phase.kind == "diurnal":
        peak = max(phase.peak_rps, phase.rate_rps)
        return phase.rate_rps + (peak - phase.rate_rps) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * u)
        )
    if phase.kind == "flash":
        lo, hi = phase.burst_window
        if lo <= u < hi:
            return phase.rate_rps * phase.burst_x
        return phase.rate_rps
    # steady / heavy_tail / rolling_update: constant
    return phase.rate_rps


def _rate_max(phase: PhaseSpec) -> float:
    if phase.kind == "diurnal":
        return max(phase.peak_rps, phase.rate_rps)
    if phase.kind == "flash":
        return phase.rate_rps * max(phase.burst_x, 1.0)
    return phase.rate_rps


def _pick_model(mix: tuple, r: float) -> str:
    acc = 0.0
    for name, w in mix:
        acc += w
        if r < acc:
            return name
    return mix[-1][0]


def build_schedule(spec: CampaignSpec) -> list:
    """Expand the spec into ``[(t, model, size), ...]`` sorted by t.

    Inhomogeneous Poisson via thinning: draw candidate arrivals at the
    phase's max rate, accept with probability rate(u)/rate_max. All
    randomness flows from ``default_rng(spec.seed)`` in a fixed draw
    order, so the schedule is a pure function of (YAML, seed) — the
    determinism pin hashes exactly this output.
    """
    rng = np.random.default_rng(spec.seed)
    out = []
    t_base = 0.0
    for phase in spec.phases:
        rmax = _rate_max(phase)
        if rmax > 0:
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / rmax))
                if t >= phase.duration_s:
                    break
                u = t / phase.duration_s
                if float(rng.random()) * rmax > _rate(phase, u):
                    continue
                model = _pick_model(phase.mix, float(rng.random()))
                size = 1
                if phase.kind == "heavy_tail":
                    draw = float(rng.pareto(phase.size_alpha))
                    size = 1 + min(phase.size_max - 1, int(draw))
                out.append((round(t_base + t, 6), model, size))
        t_base += phase.duration_s
    out.sort(key=lambda r: r[0])
    return out


def schedule_hash(schedule: list) -> str:
    """sha256 over the canonical JSON of the schedule — the determinism
    pin a campaign verdict records."""
    blob = json.dumps(
        [[f"{t:.6f}", m, s] for t, m, s in schedule], separators=(",", ":")
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def phase_window(spec: CampaignSpec, index: int) -> tuple:
    """Absolute (t_start, t_end) seconds of phase ``index``."""
    start = sum(p.duration_s for p in spec.phases[:index])
    return start, start + spec.phases[index].duration_s
