"""Static plan verifier: prove SPMD, capacity, recompilation and numeric
properties of a query plan BEFORE it runs.

Counterpart of ``repro.query.verify``.  The paper's precompiled-plan
model fixes every correctness property of a query at plan time: which
collectives run on every node, how big the exchange buffers are, which
literals force a fresh plan.  This package checks those properties from
the IR tree and the catalog statistics (plus optional artifacts of a
lowering or a run) without executing anything:

>>> from repro_torch.query.verify import verify
>>> report = verify(q, catalog)          # or: TPCHDriver.check(q)
>>> report.ok, report.clean
(True, True)
>>> print(report.text())
VERIFY q14_promo: clean

Rules have stable IDs, severities and titles, the JAX package's
(``docs/RULES.md`` catalogs them):

- ``SPMD001-004`` — collective consistency (divergent sequences,
  data-dependent guards and loops, the collective count cross-check)
- ``CAP001`` — capacity soundness under worst-case declared bindings
- ``PRM001`` — bindings outside declared ``Param`` ranges
- ``RCP001-003`` — recompilation hazards ``query/params.py`` cannot
  canonicalize
- ``NUM001-004`` — numeric hazards (zero-crossing divisions, the batched
  lane-mask product's fallback, packed-wire key-domain overflow,
  non-integral keys)
- ``SCAN001`` — a packed column scanned outside code space
- ``WIRE001`` — a forced packed wire the calibration predicts slower

Which rules can fire from what the port produces: CAP001, PRM001,
RCP001-003, NUM001-004, SCAN001 and WIRE001 read the IR, the catalog and
the lowering's decisions, as in the JAX package; SPMD001 and SPMD004 read
per-node scripts and collective records (``PlanArtifacts.shard_scripts``;
``PlanArtifacts.instructions``, where the port supplies its collective
record, ``core.exchange.collective_record()``); SPMD002 and SPMD003 fire
on scripts with data-dependent guards or loops and on HLO text given as
``PlanArtifacts(hlo=...)``, which the port's eager plans never produce
(its scripts derived from the IR have none).
"""
from repro_torch.query.verify.collectives import (  # noqa: F401
    CollectiveOp,
    collective_script,
    expected_all_to_alls,
)
from repro_torch.query.verify.core import (  # noqa: F401
    Diagnostic,
    PlanArtifacts,
    Rule,
    RULES,
    VerifyReport,
)
from repro_torch.query.verify.hlo import (  # noqa: F401
    ControlFlowCollective,
    collectives_in_control_flow,
)
from repro_torch.query.verify.rules import (  # noqa: F401
    ANALYZERS,
    VerifyContext,
    interval,
    verify,
    worst_case_binding,
)
