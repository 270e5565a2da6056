"""The benchmark's own tests: on the CPU at tiny sizes; tests marked
``gpu`` need the card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")
