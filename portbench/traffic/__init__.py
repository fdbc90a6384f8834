"""Traffic drivers, one a kind (``<kind>.py``), and the mixes they read
(``<mix>.json``)."""
