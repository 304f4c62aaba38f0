"""Command-line tools of the port: the train, dense-test and
feature-extraction CLIs (``train_recognizer``, ``test_recognizer``,
``feature_extractor``), the accuracy runbook ``validate_k400``, the host
tools ``count_flops``, ``report_accuracy`` and ``convert_checkpoint`` and,
on the card only, the kernel measurements
(``kernel_stages``)."""
