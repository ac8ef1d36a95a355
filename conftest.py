"""Repo-wide pytest hooks.

``tests/test_native_parity.py`` asks ``vq_tpu.native.available()`` while
it is imported, and on a fresh checkout that call compiles ``hsd.cpp``.
Under pytest-xdist every worker imports the file at once, and the
compilers all write the same temporary object, so some workers fail the
build and skip the whole file. Building the library once here, in the
controlling process and before any worker starts, leaves every worker a
finished ``.so`` to load.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller has built it
        return
    # Imported here, not at the top: tests/conftest.py has to set JAX's
    # flags before anything imports the package.
    from vq_tpu import native

    native.available()
