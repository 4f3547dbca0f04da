"""The port's runtime planes: the control plane's controller
(`runtime.controller`)."""
