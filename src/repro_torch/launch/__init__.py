"""repro_torch.launch — command-line entry points of the port (``serve``,
``train``), counterpart of ``repro.launch``.  The reference's dry-run,
mesh and cost-model entry points are not ported (ROADMAP §1 item 7)."""
