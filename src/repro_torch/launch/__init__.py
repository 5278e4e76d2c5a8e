"""repro_torch.launch — command-line entry points of the port (``serve``),
counterpart of ``repro.launch``.  The reference's dry-run, mesh, cost-model
and training entry points are not ported (ROADMAP §1 items 6.7 and 6.8)."""
