"""The benchmark harness of montecarloscattering_jl_tpu_torch: manifest,
trace reduction, roofline arithmetic, the import guard, the plain
reference of the reductions and the check that decides ``correct``.
Nothing here imports the port; ``main`` imports it inside its functions,
after the cell's environment is set."""
