"""The benchmark's plain reference: TLE parsing, f64 SGP4/SDP4 init and
propagation, GMST and the Earth-fixed frame, and an all-vs-all pair
search, in numpy and plain torch.

It imports nothing of the program under test. It parses the benchmark's
own TLE text and works out everything the program's set-up derives
(elements, deep-space coefficients, resonance state) again.
"""
