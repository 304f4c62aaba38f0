"""Command-line tools of the port: the dense-test CLI and, on the card
only, the kernel measurements."""
