"""The benchmark of rocm_mpi_tpu_torch (README.md beside this file)."""
