"""Declarative query IR and its lowering.

  ir      expression + operator nodes, the ``Q`` builder, catalog,
          validation, typed errors
  stats   code-space predicate rewrite and per-column scan strategy
  lower   IR -> node-stacked physical plan (bound by ``Cluster.compile``)
"""
