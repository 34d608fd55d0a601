"""repro_torch — the PyTorch/CUDA port of the distributed main-memory OLAP
engine ("Fast OLAP Query Execution in Main Memory on Large Data in a
Cluster").

The layout mirrors the JAX package ``repro`` module for module (``core/``,
``kernels/``, ``query/``, ``tpch/``), so each module's counterpart is found
under the same name.  The port imports ``torch`` and ``numpy`` only.

Cluster model: one process, one device; the P nodes of the shared-nothing
cluster are stacked on a leading tensor axis.  Entry points
(:class:`repro_torch.core.engine.Cluster`,
:class:`repro_torch.tpch.driver.TPCHDriver`) run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
