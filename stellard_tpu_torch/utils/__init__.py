"""Host utilities: protocol hashes, device selection, the wedge watchdog."""
