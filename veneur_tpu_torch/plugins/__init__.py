"""Post-flush plugins (reference plugins/plugins.go:16-19): hooks that
receive the final InterMetric batch after sink flushes. A plugin is any
object with `.name` and `.flush(metrics)`."""
