"""Launch accounting: the analytic roofline of a cell, its specs, and the
FLOP and byte count of a port step (port of ``repro/launch/``).

- :mod:`.mesh` — mesh shapes (the production meshes' and the one card's).
- :mod:`.roofline_model` — the reference's closed-form per-component
  terms, with the chip a parameter (:data:`~.roofline_model.H100`).
- :mod:`.specs` — a cell's inputs as ``meta`` tensors, its microbatches and
  its partition specs.
- :mod:`.analysis` — build a cell's step, count its FLOPs, kernel launches
  and bytes (on ``meta``, the CPU or the card), and set them beside the
  analytic terms.
- :mod:`.dryrun`, :mod:`.postprocess` — the command line over the registry.
"""
