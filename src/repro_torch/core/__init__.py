"""Engine of the port (the decode half of ``PEFTEngine``)."""
