"""Command-line tools of the port: the train and dense-test CLIs
(``train_recognizer``, ``test_recognizer``) and, on the card only, the
kernel measurements (``kernel_stages``)."""
