"""Traffic loops: one general generator per kind of traffic."""
