"""TPC-H schema, dictionaries and query parameters (paper §4.1, Fig. 1).

Dense 0-based surrogate keys; strings dictionary-encoded; dates as int32
days since 1992-01-01.  Co-partitioned pairs (solid edges in Fig. 1):
lineitem-orders on orderkey, partsupp-part on partkey.  Remote edges
(dashed): orders->customer, lineitem->part, lineitem->supplier,
partsupp->supplier, customer/supplier->nation (nation/region replicated).
"""
from __future__ import annotations

import dataclasses
import datetime

EPOCH = datetime.date(1992, 1, 1)


def day(y: int, m: int, d: int) -> int:
    """Days since 1992-01-01 (TPC-H date domain)."""
    return (datetime.date(y, m, d) - EPOCH).days


MAX_DATE = day(1998, 12, 31)

# dictionaries ---------------------------------------------------------------
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
NATIONS = tuple(f"NATION_{i:02d}" for i in range(25))  # region r owns nations 5r..5r+4
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
RETURNFLAGS = ("A", "N", "R")
LINESTATUS = ("F", "O")
ORDERSTATUS = ("F", "O", "P")
NUM_TYPES = 150      # p_type: 6 classes x 5 families x 5 finishes
NUM_BRASS = 5        # finish = p_type % 5; 'BRASS' finish index
PROMO_TYPES = 25     # p_type < 25 <=> 'PROMO%'
SUPPLIERS_PER_PART = 4
NATIONS_PER_REGION = 5


def nation_region(nationkey):
    return nationkey // NATIONS_PER_REGION


# base cardinalities at SF=1 (TPC-H §4.2.3); lineitem fanout is 1..7/order --
BASE_ROWS = {
    "orders": 1_500_000,
    "customer": 150_000,
    "part": 200_000,
    "supplier": 10_000,
}
LINEITEM_FANOUT_AVG = 4  # fixed per-node lineitem capacity = 4x orders


@dataclasses.dataclass(frozen=True)
class QueryParams:
    """TPC-H validation-run substitution parameters (§2.4 of the spec),
    mapped onto our dictionary codes / day numbers."""

    q1_shipdate_max: int = day(1998, 12, 1) - 90
    q2_size: int = 15
    q2_type_finish: int = 3                      # '%BRASS'
    q2_region: int = 3                           # EUROPE
    q3_segment: int = 1                          # BUILDING
    q3_date: int = day(1995, 3, 15)
    q4_date_min: int = day(1993, 7, 1)
    q4_date_max: int = day(1993, 10, 1)
    q5_region: int = 2                           # ASIA
    q5_date_min: int = day(1994, 1, 1)
    q5_date_max: int = day(1995, 1, 1)
    q6_date_min: int = day(1994, 1, 1)
    q6_date_max: int = day(1995, 1, 1)
    # discount window: DISCOUNT +/- 0.01 widened off the representable f32
    # grid (0.045/0.075) so f32 plan vs f64 oracle comparisons can't flip
    q6_disc_min: float = 0.045
    q6_disc_max: float = 0.075
    q6_quantity: float = 24.0
    q11_nation: int = 7                          # 'GERMANY'
    q11_fraction: float = 0.0001                 # / SF at runtime
    q14_date_min: int = day(1995, 9, 1)
    q14_date_max: int = day(1995, 10, 1)
    q15_date_min: int = day(1996, 1, 1)
    q15_date_max: int = day(1996, 4, 1)
    q18_quantity: float = 300.0
    q21_nation: int = 20                         # 'SAUDI ARABIA'


DEFAULT_PARAMS = QueryParams()
