"""The benchmark harness of msa_tpu_torch (driven by ``benchmark/run.py``).

- ``spec``     reads ``BENCHMARK.json`` and finds a cell's configuration,
               traffic and metric files by name;
- ``generate`` the problems of a run, from the configuration, the traffic
               and the seed;
- ``window``   the measured closed loop, and the run record metrics read;
- ``stats``    the order statistics the metric files use;
- ``spans``    host spans around the program's module functions (traced
               runs only);
- ``trace``    the device's busy time, kernel times and idle gaps from a
               ``torch.profiler`` trace;
- ``judge``    decides ``correct`` against the plain reference
               (``benchmark/reference``);
- ``peaks``    the card's published rates, and the work a DP cell needs;
- ``imports``  the check that no JAX module was loaded.
"""
