"""The paper's experiment program on the port: ``common.run_cell`` and
one module per table of the paper (Tables 2, 3, 4, 6, 7 and Figure 3),
copies of the reference's ``benchmarks/`` modules of the same names that
take a ``setting`` ("reference" or "full", :mod:`.common`) and a
``device``. ``python -m repro_torch.paper`` runs them."""
