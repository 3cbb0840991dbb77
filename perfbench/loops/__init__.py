"""The loops a traffic file names (its "loop"): each drives one entry of
the program through the measured window."""
