"""The byte counts of the kernels' rooflines and the peaks they are held to."""
