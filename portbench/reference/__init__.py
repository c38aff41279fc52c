"""The plain reference of the benchmark: NumPy only. It takes the genome
and the reads that the harness made, and the SAM lines the program
printed, and works out again what those lines must say. It imports
nothing of the program."""
