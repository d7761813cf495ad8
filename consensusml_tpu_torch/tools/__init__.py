"""Command-line tools of the port: the load generator and the kernel sweeps."""
