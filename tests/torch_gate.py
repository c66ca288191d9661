"""The port test files' gate on a native stage-A library.

``native.available()`` builds the library on first use.  The JAX
package's build writes one shared temporary file, so under several test
workers one that loses the rename race sees False once and would skip a
whole file without a failure.  ``available()`` caches only a success, so
asking again after the winner has finished gives the true answer."""
import time


def native_ready(native, tries=3):
    """True once ``native.available()`` has succeeded (up to ``tries``
    attempts, a second apart)."""
    for k in range(tries):
        if native.available():
            return True
        if k + 1 < tries:
            time.sleep(1)
    return False
