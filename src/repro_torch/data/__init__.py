"""TPC-H-lite data and the union workloads of the port."""
