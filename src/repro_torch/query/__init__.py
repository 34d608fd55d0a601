"""Declarative query IR and its lowering.

  ir      expression + operator nodes, the ``Q`` builder, catalog,
          validation, typed errors
  params  ``parameterize`` (a query's shape and literal binding) and
          ``bind_params``, its inverse
  stats   selectivity model, code-space predicate rewrite (literal or
          parameterized bounds) and per-column scan strategy
  lower   IR -> node-stacked physical plan (bound by ``Cluster.compile``)
"""
