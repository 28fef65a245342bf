"""The test suite; a regular package, so that ``tests.<module>`` resolves
here and not to a ``tests`` package some other install may provide."""
