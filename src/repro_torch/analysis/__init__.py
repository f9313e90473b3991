"""Compile-free analysis of the port's cells: the roofline of a traced
program (``roofline``) and its two-point extrapolation in depth
(``extrapolate``)."""
