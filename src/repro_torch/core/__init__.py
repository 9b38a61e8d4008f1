"""Math layer of the port: COO type, Kron accumulation, TTM, QRP, sweeps."""
