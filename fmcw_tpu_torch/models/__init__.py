"""The pipeline processor and the tracker."""
