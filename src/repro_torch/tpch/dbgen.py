"""Deterministic synthetic TPC-H generator (paper §4.1), node-stacked.

Counterpart of ``repro.tpch.dbgen`` with the same numpy random streams, so
one process generates the same rows with either package.  The paper
generates chunk i of every table directly in the memory of node i (``dbgen
-s SF -S rank -C P``); ``generate_node`` builds one node's partition from a
seed derived from (seed, table, node).

Co-partitioning by construction: node i's lineitems reference node i's
orders; node i's partsupps reference node i's parts.  Remote foreign keys
are uniform over the global key space.  Only nation/region are replicated.

Seeding caveat, kept on purpose: ``_rng`` mixes in ``hash(table)``, and
Python randomises string hashes per process (unless PYTHONHASHSEED is
set).  Data is identical within one process, and across the two packages
in one process, but differs from one process to the next; every consumer
checks against the oracle computed on the same data.

Generation and packing run on the host (numpy and CPU torch); the driver
moves the finished tables to the device once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.columnar import Table, pack_column, plan_packing
from repro_torch.tpch import schema as S


def table_sizes(sf: float, num_nodes: int) -> dict:
    """Per-table GLOBAL row counts: scaled, rounded to multiples of P."""
    sizes = {}
    for name, base in S.BASE_ROWS.items():
        per_node = max(32, int(round(base * sf / num_nodes)))
        sizes[name] = per_node * num_nodes
    sizes["partsupp"] = sizes["part"] * S.SUPPLIERS_PER_PART
    sizes["lineitem"] = sizes["orders"] * S.LINEITEM_FANOUT_AVG
    sizes["nation"] = 25
    sizes["region"] = 5
    return sizes


def _rng(seed: int, table: str, node: int) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, hash(table) & 0x7FFFFFFF, node])
    return np.random.default_rng(ss)


def _gen_supplier(rng, n, base):
    key = base + np.arange(n, dtype=np.int32)
    return {
        "s_suppkey": key,
        "s_nationkey": rng.integers(0, 25, n).astype(np.int32),
        "s_acctbal": (rng.uniform(-999.99, 9999.99, n)).astype(np.float32),
        "s_name_code": key,
        "s_address_code": rng.integers(0, 1 << 30, n).astype(np.int32),
        "s_phone_code": rng.integers(0, 1 << 30, n).astype(np.int32),
    }


def _gen_customer(rng, n, base):
    key = base + np.arange(n, dtype=np.int32)
    return {
        "c_custkey": key,
        "c_nationkey": rng.integers(0, 25, n).astype(np.int32),
        "c_mktsegment": rng.integers(0, len(S.SEGMENTS), n).astype(np.int32),
        "c_name_code": key,
        "c_acctbal": rng.uniform(-999.99, 9999.99, n).astype(np.float32),
    }


def _gen_part(rng, n, base):
    key = base + np.arange(n, dtype=np.int32)
    return {
        "p_partkey": key,
        "p_size": rng.integers(1, 51, n).astype(np.int32),
        "p_type": rng.integers(0, S.NUM_TYPES, n).astype(np.int32),
        "p_mfgr": rng.integers(0, 5, n).astype(np.int32),
        "p_retailprice": (900.0 + (key % 1000) + 100.0 * rng.random(n)).astype(np.float32),
        "p_name_code": key,
    }


def _gen_partsupp(rng, n_parts, part_base, num_suppliers):
    pk = np.repeat(part_base + np.arange(n_parts, dtype=np.int32), S.SUPPLIERS_PER_PART)
    n = pk.shape[0]
    return {
        "ps_partkey": pk,
        "ps_suppkey": rng.integers(0, num_suppliers, n).astype(np.int32),
        "ps_supplycost": rng.uniform(1.0, 1000.0, n).astype(np.float32),
        "ps_availqty": rng.integers(1, 10_000, n).astype(np.float32),
    }


def _gen_orders_and_lineitem(rng, n_orders, order_base, num_customers, num_parts,
                             num_suppliers):
    okey = order_base + np.arange(n_orders, dtype=np.int32)
    odate = rng.integers(0, S.day(1998, 8, 2), n_orders).astype(np.int32)

    # lineitem fanout 1..7 per order, then adjusted so the node total is
    # EXACTLY fanout_avg * n_orders (fixed per-node shapes)
    target = S.LINEITEM_FANOUT_AVG * n_orders
    nl = rng.integers(1, 8, n_orders).astype(np.int64)
    diff = int(target - nl.sum())
    # distribute the correction over orders, respecting 1..7 bounds
    idx = 0
    order_ids = np.arange(n_orders)
    rng.shuffle(order_ids)
    step = 1 if diff > 0 else -1
    while diff != 0:
        o = order_ids[idx % n_orders]
        nv = nl[o] + step
        if 1 <= nv <= 7:
            nl[o] = nv
            diff -= step
        idx += 1
    assert nl.sum() == target

    l_order_local = np.repeat(np.arange(n_orders, dtype=np.int32), nl)
    n_li = l_order_local.shape[0]
    l_odate = odate[l_order_local]
    qty = rng.integers(1, 51, n_li).astype(np.float32)
    price_base = rng.uniform(900.0, 2000.0, n_li).astype(np.float32)
    extprice = (qty * price_base).astype(np.float32)
    disc = (rng.integers(0, 11, n_li) / 100.0).astype(np.float32)
    tax = (rng.integers(0, 9, n_li) / 100.0).astype(np.float32)
    shipdate = (l_odate + rng.integers(1, 122, n_li)).astype(np.int32)
    commitdate = (l_odate + rng.integers(30, 91, n_li)).astype(np.int32)
    receiptdate = (shipdate + rng.integers(1, 31, n_li)).astype(np.int32)
    linestatus = (shipdate > S.day(1995, 6, 17)).astype(np.int32)  # O after cutoff
    returnflag = np.where(
        receiptdate <= S.day(1995, 6, 17),
        rng.integers(0, 2, n_li),          # A or N for old receipts
        2 * np.ones(n_li, dtype=np.int64),  # R
    ).astype(np.int32)
    # TPC-H: returnflag in {R,A,N}; keep all three present:
    returnflag = np.where(rng.random(n_li) < 0.33, 1, returnflag).astype(np.int32)

    lineitem = {
        "l_orderkey": okey[l_order_local],
        "l_partkey": rng.integers(0, num_parts, n_li).astype(np.int32),
        "l_suppkey": rng.integers(0, num_suppliers, n_li).astype(np.int32),
        "l_quantity": qty,
        "l_extendedprice": extprice,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
    }

    # o_totalprice from the co-located lineitems (TPC-H semantics)
    charge = extprice * (1.0 - disc) * (1.0 + tax)
    totalprice = np.zeros(n_orders, np.float64)
    np.add.at(totalprice, l_order_local, charge.astype(np.float64))
    orders = {
        "o_orderkey": okey,
        "o_custkey": rng.integers(0, num_customers, n_orders).astype(np.int32),
        "o_orderdate": odate,
        "o_orderpriority": rng.integers(0, 5, n_orders).astype(np.int32),
        "o_orderstatus": rng.integers(0, 3, n_orders).astype(np.int32),
        "o_totalprice": totalprice.astype(np.float32),
        "o_comment_special": (rng.random(n_orders) < 0.02),
    }
    return orders, lineitem


def generate_node(sf: float, node: int, num_nodes: int, seed: int = 0) -> dict:
    """All table partitions of one node (the paper's `dbgen -S node -C P`),
    as numpy arrays."""
    sizes = table_sizes(sf, num_nodes)
    out = {}
    n_sup = sizes["supplier"] // num_nodes
    out["supplier"] = _gen_supplier(_rng(seed, "supplier", node), n_sup, node * n_sup)
    n_cust = sizes["customer"] // num_nodes
    out["customer"] = _gen_customer(_rng(seed, "customer", node), n_cust, node * n_cust)
    n_part = sizes["part"] // num_nodes
    out["part"] = _gen_part(_rng(seed, "part", node), n_part, node * n_part)
    out["partsupp"] = _gen_partsupp(
        _rng(seed, "partsupp", node), n_part, node * n_part, sizes["supplier"]
    )
    n_ord = sizes["orders"] // num_nodes
    orders, lineitem = _gen_orders_and_lineitem(
        _rng(seed, "orders", node), n_ord, node * n_ord,
        sizes["customer"], sizes["part"], sizes["supplier"],
    )
    out["orders"] = orders
    out["lineitem"] = lineitem
    return out


def _replicated_tables() -> dict:
    nk = np.arange(25, dtype=np.int32)
    nation = Table(
        "nation",
        {"n_nationkey": torch.from_numpy(nk),
         "n_regionkey": torch.from_numpy(
             (nk // S.NATIONS_PER_REGION).astype(np.int32))},
        dictionaries={"n_nationkey": S.NATIONS},
        replicated=True,
    )
    rk = np.arange(5, dtype=np.int32)
    region = Table(
        "region",
        {"r_regionkey": torch.from_numpy(rk)},
        dictionaries={"r_regionkey": S.REGIONS},
        replicated=True,
    )
    return {"nation": nation, "region": region}


DICTIONARIES = {
    "customer": {"c_mktsegment": S.SEGMENTS},
    "orders": {"o_orderpriority": S.PRIORITIES, "o_orderstatus": S.ORDERSTATUS},
    "lineitem": {"l_returnflag": S.RETURNFLAGS, "l_linestatus": S.LINESTATUS},
}


def generate(sf: float, num_nodes: int, seed: int = 0,
             storage: str = "raw") -> dict:
    """Node-stacked host tables assembled from per-node chunks.

    ``storage="packed"`` generates eligible columns straight into the
    compressed-resident :class:`~repro_torch.core.columnar.PackedColumn`
    format (dictionary / frame-of-reference bit-packing with globally
    consistent width/offset/dictionary across node chunks).  Ineligible
    columns (wide key spans, high-entropy floats) stay raw ``(P, rows)``
    tensors; replicated tables always stay raw."""
    if storage not in ("raw", "packed"):
        raise ValueError(f"storage must be 'raw' or 'packed', got {storage!r}")
    chunks = [generate_node(sf, node, num_nodes, seed) for node in range(num_nodes)]
    tables = {}
    for name in ("supplier", "customer", "part", "partsupp", "orders", "lineitem"):
        cols = {}
        for cname in chunks[0][name]:
            cchunks = [chunks[n][name][cname] for n in range(num_nodes)]
            spec = plan_packing(cchunks) if storage == "packed" else None
            cols[cname] = (pack_column(cchunks, spec) if spec is not None
                           else torch.from_numpy(np.stack(cchunks)))
        tables[name] = Table(name, cols, DICTIONARIES.get(name, {}))
    tables.update(_replicated_tables())
    return tables
