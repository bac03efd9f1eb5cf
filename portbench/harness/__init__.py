"""The benchmark's yardstick: the run's frame, the registry of files, the
boundary, the trace's reduction, the rooflines' peaks and the check."""
