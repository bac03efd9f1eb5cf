/* A plugin likelihood in the reference's C ABI (reference:
 * examples/dll_likelihood/code.cpp, src/likelihoods/LikelihoodDLL.cpp):
 * log p = -0.5 * sum of squares of the values. The evaluation fails
 * (returns false) where the first value is beyond 5, so that a caller
 * sees both outcomes. Build: cc -shared -fPIC -o gaussian_plugin.so gaussian_plugin.c
 */
#include <stddef.h>

int initialize_likelihood(size_t n, const char* const* names)
{
    (void)names;
    return n > 0;
}

int evaluate_log_probability(ptrdiff_t n, const double* values, const char** names,
                             double* log_p)
{
    (void)names;
    if (values[0] > 5.0 || values[0] < -5.0)
        return 0;
    double s = 0.0;
    for (ptrdiff_t i = 0; i < n; i++)
        s += values[i] * values[i];
    *log_p = -0.5 * s;
    return 1;
}
