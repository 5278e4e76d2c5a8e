"""repro_torch.launch — command-line entry points of the port (``serve``,
``train``, ``dryrun``), the H100 mesh and its peak rates (``mesh``) and
the analytic cost model (``costmodel``, ``hlo_analysis.roofline_terms``),
counterpart of ``repro.launch``."""
