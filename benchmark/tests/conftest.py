"""The benchmark's own tests. Those that need a CUDA card carry the `gpu`
marker and decide inside the test whether there is one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")
