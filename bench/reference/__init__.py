"""The benchmark's plain reference: LIF profile, partition and placement
recounts, and a cycle-stepped NoC replay.  It imports nothing of the program."""
