"""waterorderlib_tpu: accelerated water-structure trajectory analysis.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
hansWermhat/WaterOrderLib (a CPU Fortran/f2py molecular-dynamics analysis
library): order parameters (q_tet, 3-body angles, LSI, psi6), radial
distribution functions, hydrogen-bond statistics and clustering,
hydration-shell decomposition, density/interface fields, SASA and Voronoi
analyses — computed over HBM-resident (frames, atoms, 3) coordinate tensors,
vmapped over frames and shardable across a device mesh (one to four
GPUs, or virtual CPU devices in tests).
"""

__version__ = "0.1.0"
