"""Command-line tools of the port: the train, dense-test and
feature-extraction CLIs (``train_recognizer``, ``test_recognizer``,
``feature_extractor``), the host tools ``count_flops`` and
``report_accuracy`` and, on the card only, the kernel measurements
(``kernel_stages``)."""
