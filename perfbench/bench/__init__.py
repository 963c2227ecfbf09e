"""The harness's general parts: the manifest and the files it names, the
inputs made from the seed, the device trace, the table of peaks."""
