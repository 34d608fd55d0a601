"""Launchers of the port (counterpart of ``repro.launch``): training
(``train``) and OLAP serving (``serve_olap``)."""
