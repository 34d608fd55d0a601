"""Hand-plan exchange capacities derived from the §3.2.2 selectivity model.

Counterpart of ``repro.tpch.capacities``.  Each capacity is
``capacity_for(the expected per-destination message count)``, from the
same selectivity estimates the IR lowering uses: requests after local filtering spread
uniformly over P destinations, plus a 6-sigma binomial tail margin.  Run-
time overflow flags in the exchange layer catch any under-estimate.
:func:`wire_formats` derives each hand-plan exchange's packed wire format
(target table rows -> per-destination key domain -> key bits), and
:func:`wire_predictions` the latency model's wire choice and predicted
times for each under the port's wire calibration (``core.wirecal``).

Knobs that are NOT exchange buffers (lazy-top-k chunk/round counts, the
§3.2.5 codec group/candidate sizes) remain explicit algorithm parameters.
"""
from __future__ import annotations

from repro_torch.query.stats import capacity_for, wire_format_for
from repro_torch.tpch import dbgen
from repro_torch.tpch import schema as S
from repro_torch.tpch.schema import DEFAULT_PARAMS


def _date_sel(lo: int, hi: int) -> float:
    """Selectivity of a [lo, hi) window on the uniform order-date domain."""
    span = S.day(1998, 8, 2)
    return max(0.0, min(1.0, (hi - lo) / span))


def derive(sf: float, num_nodes: int, params=DEFAULT_PARAMS) -> dict:
    """Per-plan capacities for a TPC-H instance of this size."""
    sizes = dbgen.table_sizes(sf, num_nodes)
    P = max(num_nodes, 1)

    def per_dest(table: str, sel: float) -> float:
        return sizes[table] / P * sel / P

    # Q2: partsupp survivors of the part filter (p_size == v: 1/50;
    # p_type % 5 == finish: 1/5) request the supplier-region bit (Alt-1);
    # the minima (~one per qualifying part, <= 4 with cost ties) are then
    # routed to their supplier owners.
    q2_sel = (1.0 / 50.0) * (1.0 / S.NUM_BRASS)
    q2_owner = (per_dest("part", 1.0 / 50.0 / S.NUM_BRASS)
                * S.SUPPLIERS_PER_PART)
    # Q5: date-qualified orders request their customer's nation.
    q5_sel = _date_sel(params.q5_date_min, params.q5_date_max)
    # Q13: nearly every order (2% comment filter) routes to its customer.
    q13_sel = 0.98
    # Q14: lineitems in the one-month ship window request the part type.
    q14_sel = _date_sel(params.q14_date_min, params.q14_date_max)
    # Q21 (late): one request per ACTIVE supplier key; keys are dense and
    # range-partitioned, so each node addresses at most rows_per_node keys
    # to any single owner — that hard bound is the capacity driver.
    q21_e = sizes["supplier"] / P

    return {
        "q2_request": capacity_for(per_dest("partsupp", q2_sel)),
        "q2_owner": capacity_for(q2_owner),
        "q5_request": capacity_for(per_dest("orders", q5_sel)),
        "q13_route": capacity_for(per_dest("orders", q13_sel)),
        "q14_request": capacity_for(per_dest("lineitem", q14_sel)),
        "q21_request": capacity_for(q21_e),
        # algorithm parameters (not exchange buffers):
        "q3_chunk": 256,       # §3.2.4 lazy top-k candidate chunk
        "q3_rounds": 64,       # bound on the lazy rounds
        "q15_group": 1024,     # §3.2.5 codec group (shrunk to fit per-node)
        "q15_candidates": 256,  # §3.2.5 exact-value candidate buffer
    }


# each hand-plan exchange -> the table whose owners it addresses (the wire
# codec packs keys to that table's per-destination domain width)
_EXCHANGE_TARGETS = {
    "q2_request": "supplier",
    "q2_owner": "supplier",
    "q3_request": "customer",
    "q5_request": "customer",
    "q13_route": "customer",
    "q14_request": "part",
    "q21_request": "supplier",
}


def wire_formats(tables, num_nodes: int) -> dict:
    """Packed §3.2.1 wire format per hand-plan exchange, derived from the
    loaded tables (``TPCHDriver.tables``) so the per-destination key
    domains match the execution context's partitionings exactly."""
    return {
        name: wire_format_for(int(tables[target].num_rows), num_nodes)
        for name, target in _EXCHANGE_TARGETS.items()
    }


def wire_predictions(tables, num_nodes: int, capacities: dict,
                     cal=None) -> dict:
    """Roofline latency predictions per hand-plan exchange: name ->
    ``{"kind", "codec_ms", "wire_ms"}`` under the wire calibration
    (``core.wirecal``: the port's saved one, else the builtin rates, when
    None).  ``kind`` is what the latency model would CHOOSE for that
    exchange: hand plans run with a fixed wire can be audited against it
    (rule WIRE001)."""
    from repro_torch.core import wirecal

    cal = cal if cal is not None else wirecal.load()
    out = {}
    for name, target in _EXCHANGE_TARGETS.items():
        cap = int(capacities.get(name, 0))
        if cap <= 0:
            continue
        wf = wire_format_for(int(tables[target].num_rows), num_nodes)
        kind = wirecal.choose_wire_kind(cap, num_nodes, wf.domain, cal=cal)
        codec_ms, wire_ms = wirecal.predict_alt1_ms(
            cap, num_nodes, wf.domain, packed=kind == "packed", cal=cal)
        out[name] = {"kind": kind, "codec_ms": codec_ms, "wire_ms": wire_ms}
    return out
