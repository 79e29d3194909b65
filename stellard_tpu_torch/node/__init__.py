"""Node services of the device plane: the coalescing verify plane."""
