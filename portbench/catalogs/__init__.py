"""Seeded catalog generators: a configuration file names its generator
(``"generator"``), whose ``text(config, seed)`` returns the TLE text."""
