"""The plain float64 reference the comparison judges the program by."""
