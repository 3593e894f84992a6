def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc; skipped without them "
        "(run on the card with `pytest -m cuda tests/test_torch_*.py`)",
    )
